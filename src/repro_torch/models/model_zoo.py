"""Model interface over the port's architectures (counterpart of
``repro/models/model_zoo.py``): ``LanguageModel`` (decoder-only, with its
dense-cache serving hooks and its paged hooks) and ``EncDecModel``
(seamless-m4t), chosen by :func:`build_model` from the config's family.

Batches are dicts: ``tokens`` (+ ``labels`` for training, ``vision_embeds``
for vlm, ``src_embeds`` and optionally ``src_len`` for encdec).
``forward`` returns the hidden states (the serving signature: the
reference returns the MoE aux loss beside them, which ``loss`` adds here);
``loss`` is the training objective, the chunked cross-entropy.
"""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import encdec, layers, transformer, vlm
from repro_torch.runtime import mesh_ctx

MOE_AUX_COEF = 0.01


def _loss_chunks(s: int, n_loss_chunks: int) -> int:
    """The reference's chunk count: halved until it divides ``s``."""
    while s % n_loss_chunks:
        n_loss_chunks //= 2
    return max(n_loss_chunks, 1)


def _loss_table(params, name) -> dict:
    """The loss's unembedding table (a training tree's: no fp32 copy),
    gathered once for the whole loss (``mesh_ctx.working``), not once a
    chunk: the chunks' checkpoints keep it as their input."""
    return {"table": mesh_ctx.working(params[name]["table"], (name, "table"))}


class LanguageModel:
    """Decoder-only stacks: GQA or MLA attention (global or sliding-window
    layers, RoPE or qwen2-vl's M-RoPE), RG-LRU and Mamba-2 layers, dense or
    MoE MLPs; served over a dense cache (K/V rows and recurrent/SSM state
    per slot) or, for MLA attention-only stacks, a paged one."""

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

    def _positions(self, batch, tokens, cache_len=None):
        """M-RoPE positions ``(3, B, S)`` for a vlm (patches first when
        ``batch`` holds ``vision_embeds`` and there is no ``cache_len``;
        text-only, at ``cache_len``, otherwise), None for every other
        family (``lm_apply``'s default).  A decode step after a vision
        prefill positions its token at ``cache_len``, not after the
        prompt's last text position, as the reference does."""
        if self.cfg.family != "vlm":
            return None
        nv = 0
        if "vision_embeds" in batch and cache_len is None:
            nv = batch["vision_embeds"].shape[1]
        return vlm.mrope_positions(tokens.shape[0], tokens.shape[1], nv, offset=cache_len,
                                   device=tokens.device)

    def forward(self, params, batch) -> torch.Tensor:
        """Hidden states ``(B, S, d)`` after the final norm of
        ``batch["tokens"]``, a vlm's ``vision_embeds`` over its first
        positions."""
        tokens = batch["tokens"]
        hidden, _, _ = transformer.lm_apply(
            params, tokens, cfg=self.cfg, positions=self._positions(batch, tokens),
            embeds_override=batch.get("vision_embeds"), dtype=self.dtype,
        )
        return hidden

    def loss(self, params, batch, *, remat=False, n_loss_chunks=8):
        """Mean next-token cross-entropy of ``batch["labels"]`` (``-1``
        ignored; chunked, :func:`~repro_torch.models.layers.chunked_cross_entropy`),
        plus ``MOE_AUX_COEF`` times the summed load-balancing loss for a
        MoE stack; ``remat`` runs each layer again in the backward.  Under a
        tensor-parallel plan the loss is vocabulary-parallel (the plan's
        ``logits`` split)."""
        tokens = batch["tokens"]
        hidden, _, aux = transformer.lm_apply(
            params, tokens, cfg=self.cfg, positions=self._positions(batch, tokens),
            embeds_override=batch.get("vision_embeds"), remat=remat, dtype=self.dtype,
        )
        ce = layers.chunked_cross_entropy(
            _loss_table(params, "unembed" if "unembed" in params else "embed"), hidden,
            batch["labels"],
            n_chunks=_loss_chunks(hidden.shape[1], n_loss_chunks),
            softcap=self.cfg.final_softcap, dtype=self.dtype, tp=mesh_ctx.tp_split("logits"),
        )
        if self.cfg.n_experts:
            ce = ce + MOE_AUX_COEF * aux
        return ce

    def logits(self, params, hidden):
        return transformer.lm_logits(params, hidden, cfg=self.cfg, dtype=self.dtype)

    # -- serving: dense cache backend -------------------------------------- #
    def init_cache(self, params, batch_size, max_len, dtype=None) -> list:
        """Zeroed per-layer dense caches (K/V or latent rows, or a
        recurrent/SSM layer's fp32 state) on the device of ``params``."""
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
        hidden, cache, _ = transformer.lm_apply(
            params, tokens, cfg=self.cfg,
            positions=self._positions({}, tokens, cache_len=cache_len),
            cache=cache, cache_len=cache_len, dtype=self.dtype,
        )
        pos = hidden.shape[1] - 1 if last_pos is None else int(last_pos)
        return self.logits(params, hidden[:, pos : pos + 1]), cache

    def decode_step(self, params, cache, tokens, cache_len):
        """tokens: (B, Sq) new tokens at per-slot offsets ``cache_len``;
        returns (logits (B, Sq, V), cache)."""
        hidden, cache, _ = transformer.lm_apply(
            params, tokens, cfg=self.cfg,
            positions=self._positions({}, tokens, cache_len=cache_len),
            cache=cache, cache_len=cache_len, dtype=self.dtype,
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


class EncDecModel:
    """Encoder-decoder family (seamless-m4t).  Served as the reference
    serves it: :meth:`init_cache` runs the encoder over a request batch's
    frame embeddings and precomputes the cross K/V, then
    :meth:`decode_step` runs the target prompt (at ``cache_len`` 0) and one
    token a step; there is no serving session."""

    def __init__(self, cfg):
        if cfg.family != "encdec" or not cfg.encoder_layers:
            raise ValueError(f"config {cfg.name!r} is not an encoder-decoder")
        self.cfg = cfg
        self.dtype = transformer.cfg_dtype(cfg)

    def init(self, generator: torch.Generator, device="cuda", dtype=None) -> dict:
        """Random parameters drawn from ``generator`` (which must live on
        ``device``) in ``dtype`` (default: the config's)."""
        dev = resolve_device(device)
        return encdec.encdec_init(generator, self.cfg, device=dev, dtype=dtype or self.dtype)

    def forward(self, params, batch) -> torch.Tensor:
        """Decoder hidden states ``(B, St, d)`` of ``batch["tokens"]`` over
        the encoded ``batch["src_embeds"]`` (cross-attention bounded by
        ``batch["src_len"]`` where given)."""
        memory = encdec.encode(params, batch["src_embeds"], cfg=self.cfg, dtype=self.dtype)
        hidden, _ = encdec.decode_stack(
            params, batch["tokens"], memory, cfg=self.cfg,
            memory_len=batch.get("src_len"), dtype=self.dtype,
        )
        return hidden

    def loss(self, params, batch, *, remat=False, n_loss_chunks=8):
        """Mean cross-entropy of the decoder's ``batch["labels"]`` (``-1``
        ignored, chunked) over the tied table; ``remat`` is accepted and
        ignored, as in the reference.  Under a tensor-parallel plan the
        loss is vocabulary-parallel (the plan's ``logits`` split)."""
        del remat
        hidden = self.forward(params, batch)
        return layers.chunked_cross_entropy(
            _loss_table(params, "embed"), hidden, batch["labels"],
            n_chunks=_loss_chunks(hidden.shape[1], n_loss_chunks), dtype=self.dtype,
            tp=mesh_ctx.tp_split("logits"),
        )

    def logits(self, params, hidden):
        """fp32 vocabulary logits of ``hidden`` over the tied table (under a
        tensor-parallel plan this rank's rows, gathered)."""
        return layers.unembed(transformer.working_table(params, "embed", self.dtype), hidden,
                              dtype=self.dtype, tp=mesh_ctx.tp_split("logits"))

    def init_cache(self, params, src_embeds, max_len, dtype=None) -> dict:
        """Encode ``src_embeds (B, Ss, d)`` and precompute every layer's
        cross K/V; zeroed self-attention caches of ``max_len`` rows."""
        return encdec.encdec_cache_init(params, self.cfg, src_embeds, max_len,
                                        dtype=dtype or self.dtype)

    def decode_step(self, params, cache, tokens, cache_len):
        """tokens: (B, St) at per-slot offsets ``cache_len`` (the target
        prompt at 0, then one token a step); returns (logits (B, St, V),
        cache), the self-attention rows written in place."""
        hidden, cache = encdec.decode_stack(
            params, tokens, None, cfg=self.cfg, cache=cache, cache_len=cache_len,
            dtype=self.dtype,
        )
        return self.logits(params, hidden), cache


def build_model(cfg):
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    return LanguageModel(cfg)
