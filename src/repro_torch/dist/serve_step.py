"""Serving steps: prefill, one-token greedy decode, and the decode loop
(port of ``repro/dist/serve_step.py``).

``build_prefill_step`` scores whole requests: one forward over (B, S)
tokens with attention through the flash-attention kernel (its plain
version on the CPU).  ``build_serve_step`` is the unit of generation: one
token in, one greedy token out, the KV caches updated in place.  The cache
layout is whatever :func:`repro_torch.models.transformer.init_caches`
produced -- a ring buffer of size ``window`` for sliding-window archs, the
full ``max_len`` otherwise -- and the step position is the only thing that
changes from call to call.  ``decode_loop`` feeds the prompt token by
token through the same step, then generates greedily.  All three run
without autograd.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["build_prefill_step", "build_serve_step", "decode_loop"]


def build_prefill_step(cfg: ModelConfig, *, tp=None):
    """``prefill(params, batch) -> logits (B, S, V)`` fp32, for request
    scoring; ``batch`` is ``{"tokens": (B, S_tok)}``, plus
    ``"prefix_embeds"`` (B, P, d_frontend) for a config with a frontend,
    and then S = P + S_tok.  With ``tp`` the rank's rows and vocabulary
    block (module docstring)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(params, batch, cfg, tp)

    return prefill_step


def build_serve_step(cfg: ModelConfig, *, max_len: int, tp=None):
    """``serve(params, caches, tokens, step) -> (next_tokens, caches)``:
    ``tokens`` is ``(B, 1)``, ``step`` the int position, ``next_tokens``
    the ``(B, 1)`` int32 greedy argmax; the caches (from
    ``transformer.init_caches`` with this ``max_len``) are updated in place
    and returned.  With ``tp`` the rank's rows and blocks (module
    docstring)."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, step):
        logits, caches = transformer.decode_step(params, tokens, caches,
                                                 step, cfg, max_len=max_len,
                                                 tp=tp)
        last = logits[:, -1:]
        if tp is not None and last.shape[-1] != cfg.vocab_size:
            nxt = tp.vocab_argmax(last)
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.to(torch.int32), caches

    return serve_step


def check_lengths(S: int, num_steps: int, max_len: int) -> None:
    """Raise ``ValueError`` unless a prompt of ``S`` tokens and
    ``num_steps`` generated ones fit greedy decoding with a ``max_len``
    cache (the checks of :func:`decode_loop`)."""
    if S == 0:
        raise ValueError(
            "decode_loop needs a non-empty prompt (S >= 1): generation is "
            "seeded by the last prompt token's logits.  To generate "
            "unconditionally, pass a (B, 1) BOS-token prompt instead")
    if num_steps < 1:
        raise ValueError(f"decode_loop needs num_steps >= 1, got "
                         f"{num_steps}")
    if S + num_steps > max_len:
        raise ValueError(f"prompt ({S}) + generation ({num_steps}) exceeds "
                         f"max_len={max_len}")


def decode_loop(params, cfg: ModelConfig, prompts: torch.Tensor, *,
                num_steps: int, max_len: int,
                cache_dtype: torch.dtype = torch.float32,
                tp=None) -> torch.Tensor:
    """Greedy generation over the serve step.

    The prompt is consumed through the same serve step used for
    generation (lockstep batch decoding); the last prompt step's output is
    generated token 0, so only ``num_steps - 1`` further steps run.

    Args:
      params: model parameters (on the device the step runs on; with
        ``tp`` the rank's blocks).
      cfg: model config.
      prompts: ``(B, S)`` prompt tokens, ``S >= 1`` (the last prompt
        token's logits seed generation); the whole batch, also with
        ``tp``.
      num_steps: number of tokens to generate.
      max_len: cache length; requires ``S + num_steps <= max_len``.
      cache_dtype: KV cache dtype.
      tp: the serving group (module docstring).
    Returns:
      ``(B, num_steps)`` int32 greedily generated tokens; with ``tp`` the
      rank's rows of them (its data group's).
    """
    from repro_torch.dist.sharding import local_block
    B, S = prompts.shape
    check_lengths(S, num_steps, max_len)
    caches = transformer.init_caches(cfg, B, max_len, cache_dtype,
                                     device=prompts.device)
    prompts = prompts[local_block((B, S), ("sub_batch", None))]
    step_fn = build_serve_step(cfg, max_len=max_len, tp=tp)
    for t in range(S):
        tok, caches = step_fn(params, caches, prompts[:, t:t + 1], t)
    out = [tok]
    for t in range(S, S + num_steps - 1):
        tok, caches = step_fn(params, caches, tok, t)
        out.append(tok)
    return torch.cat(out, dim=1)
