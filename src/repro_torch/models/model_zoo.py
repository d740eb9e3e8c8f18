"""Model interface over the port's architectures (counterpart of
``repro/models/model_zoo.py``: ``LanguageModel`` with its dense-cache
serving hooks and its paged hooks)."""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import transformer


class LanguageModel:
    """Decoder-only attention stacks (GQA or MLA, global or sliding-window
    layers, dense MLP), served over a dense or a paged cache."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.dtype = transformer.cfg_dtype(cfg)

    def init(self, generator: torch.Generator, device="cuda", dtype=None) -> dict:
        """Random parameters drawn from ``generator`` (which must live on
        ``device``) in ``dtype`` (default: the config's), tensor by tensor
        on the device."""
        dev = resolve_device(device)
        return transformer.lm_init(
            generator, self.cfg, device=dev, dtype=dtype or self.dtype
        )

    def logits(self, params, hidden):
        return transformer.lm_logits(params, hidden, cfg=self.cfg, dtype=self.dtype)

    # -- serving: dense cache backend -------------------------------------- #
    def init_cache(self, params, batch_size, max_len, dtype=None) -> list:
        """Zeroed per-layer dense caches on the device of ``params``."""
        return transformer.lm_cache_init(
            self.cfg, batch_size, max_len, dtype=dtype or self.dtype,
            device=params["embed"]["table"].device,
        )

    def prefill(self, params, cache, tokens, *, cache_len=None, last_pos=None):
        """Prefill ``tokens (B, S)`` into ``cache`` (in place); returns the
        logits ``(B, 1, V)`` at ``last_pos`` (default the last position),
        so right-padded prompts still sample from their true last token."""
        if cache_len is None:
            cache_len = 0
        hidden, cache = transformer.lm_apply(
            params, tokens, cfg=self.cfg, cache=cache, cache_len=cache_len,
            dtype=self.dtype,
        )
        pos = hidden.shape[1] - 1 if last_pos is None else int(last_pos)
        return self.logits(params, hidden[:, pos : pos + 1]), cache

    def decode_step(self, params, cache, tokens, cache_len):
        """tokens: (B, Sq) new tokens at per-slot offsets ``cache_len``;
        returns (logits (B, Sq, V), cache)."""
        hidden, cache = transformer.lm_apply(
            params, tokens, cfg=self.cfg, cache=cache, cache_len=cache_len,
            dtype=self.dtype,
        )
        return self.logits(params, hidden), cache

    # -- serving: paged cache backend -------------------------------------- #
    def init_paged_cache(self, params, *, num_pages, page_size=None, dtype=None, spec=None):
        """A LayeredPagedKVCache sized for this model's latent geometry, on
        the device of ``params``; ``spec`` wins over ``dtype``."""
        from repro_torch.kernels.mla_decode_paged import DEFAULT_PAGE_SIZE
        from repro_torch.runtime.kv_cache import LayeredPagedKVCache

        transformer.check_paged_compatible(self.cfg)
        m = self.cfg.mla
        return LayeredPagedKVCache(
            num_layers=self.cfg.n_layers,
            num_pages=num_pages,
            page_size=page_size or DEFAULT_PAGE_SIZE,
            width=m.d_latent + m.d_rope,
            dtype=dtype or self.dtype,
            spec=spec,
            device=params["embed"]["table"].device,
        )

    def layer_params(self, params) -> list:
        """Per-layer param list for the host-side paged layer walk."""
        return params["layers"]

    def prefill_paged(self, params, cache, rid, tokens, **kw):
        """Chunked prefill-into-pages; returns last-token logits (1, V)."""
        return transformer.lm_prefill_paged(
            params, tokens, cfg=self.cfg, cache=cache, rid=rid, **kw
        )

    def decode_step_paged(self, params, cache, rids, tokens, **kw):
        """One paged decode step over live ``rids``; logits (B, S, V)."""
        return transformer.lm_decode_step_paged(
            params, tokens, cfg=self.cfg, cache=cache, rids=rids, **kw
        )


def build_model(cfg):
    return LanguageModel(cfg)
