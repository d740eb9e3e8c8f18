"""Deterministic synthetic LM data pipeline (copied from
``repro/data/pipeline.py``: numpy only, bit-equal batches).

Production properties we implement for real (and test):
  * **determinism**: batch contents are a pure function of (seed, step,
    shard) — restarting from a checkpoint at step k replays the exact
    stream without storing reader state;
  * **host sharding**: each host generates only its shard of the global
    batch (shard_id / num_shards);
  * **background prefetch**: a worker thread keeps a bounded queue of
    upcoming batches so host data generation overlaps device compute;
  * **packing**: documents of random length packed into fixed seq_len rows
    with EOS separators and loss-masked padding (labels = -1).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

EOS = 1
PAD = 0
IGNORE = -1


class SyntheticLMData:
    def __init__(
        self,
        *,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        num_shards: int = 1,
        shard_id: int = 0,
        mean_doc_len: int = 512,
    ):
        if global_batch % num_shards:
            raise ValueError(f"global_batch={global_batch} does not split into {num_shards} shards")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.mean_doc_len = mean_doc_len

    # -- deterministic access ------------------------------------------------
    def batch_at(self, step: int) -> dict:
        """Generate this host's shard of batch ``step`` (pure function)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id])
        )
        b, s = self.local_batch, self.seq_len
        tokens = np.empty((b, s), np.int32)
        loss_mask = np.ones((b, s), bool)
        for i in range(b):
            row, pos = [], 0
            while pos < s:
                dlen = int(rng.geometric(1.0 / self.mean_doc_len))
                dlen = max(2, min(dlen, s - pos))
                doc = rng.integers(2, self.vocab_size, size=dlen)
                doc[-1] = EOS
                row.append(doc)
                pos += dlen
            tokens[i] = np.concatenate(row)[:s]
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = IGNORE
        labels = np.where(loss_mask, labels, IGNORE)
        return {"tokens": tokens, "labels": labels.astype(np.int32)}

    # -- prefetching iterator -------------------------------------------------
    def iterate(self, start_step: int = 0, prefetch: int = 2):
        """Background-prefetched iterator starting at ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put((step, self.batch_at(step)), timeout=0.1)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
