"""Whether what the timed path served is right: a sample of the served
requests (drawn from the seed, the one with the most served tokens always
in it) is run through the plain reference, once, over each prompt and its
served tokens; every served token's reference logit is held against the
reference's best logit at that position.  The widest gap (logit units) is
compared with the cell's limit.

:func:`gaps` also reads, on the same sample and by the same measure, what
a limit is set against (the calibration, never a benchmark run): the
control, the reference at the precision below the configuration's in the
program's place (the token the fp8 reference puts first at each position),
and two faults planted in the reference put in the program's place."""

from __future__ import annotations

import numpy as np
import torch

def sample(records, k: int, seed: int) -> list:
    """``k`` records with served tokens: the one with the most, then others
    drawn from ``seed``."""
    served = [r for r in records if r.tokens]
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: (len(served[i].tokens), len(served[i].prompt)))
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng(seed)
    pick = [longest] + [int(i) for i in rng.permutation(rest)[: max(k - 1, 0)]]
    return [served[i] for i in pick]


def _inputs(records, device):
    seqs, want = [], []
    for r in records:
        toks = list(r.prompt) + list(r.tokens[:-1])
        seqs.append(torch.tensor(toks, dtype=torch.int64, device=device))
        p = len(r.prompt) - 1
        want.append(torch.arange(p, p + len(r.tokens), device=device))
    return seqs, want


def gaps(reference, params, model, records, device, readings=("program",)) -> dict:
    """The widest gap of each reading under the fp32 reference, and the
    number of served tokens compared (``"tokens"``).  Readings:

    * ``program``: the served tokens;
    * ``control``: the first choice of the reference in fp8;
    * ``state_unchanged``: the first choice of the fp32 reference whose
      decode drops the rows it wrote (a generated token's key and value
      are seen by its own query alone): a step that leaves its cache
      unchanged;
    * ``token_altered``: each served token replaced by the next id.
    """
    seqs, want = _inputs(records, device)
    ref = reference.logits(params, model, seqs, want, precision="fp32")
    served = [torch.tensor(r.tokens, dtype=torch.int64, device=device) for r in records]
    out = {"tokens": sum(int(t.shape[0]) for t in served)}
    for name in readings:
        if name == "program":
            picks = served
        elif name == "token_altered":
            picks = [(t + 1) % model["vocab_size"] for t in served]
        elif name in ("control", "state_unchanged"):
            kw = ({"precision": "fp8"} if name == "control"
                  else {"drop_written": [len(r.prompt) for r in records]})
            low = reference.logits(params, model, seqs, want, **kw)
            picks = [lg.argmax(dim=-1) for lg in low]
            del low
        else:
            raise ValueError(f"unknown reading {name!r}")
        widest = 0.0
        for lg, pk in zip(ref, picks):
            g = lg.max(dim=-1).values - lg.gather(-1, pk[:, None])[:, 0]
            widest = max(widest, float(g.max()))
        out[name] = widest
    return out
