"""Where the flash-attention kernel's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe
    PYTHONPATH=src python -m repro_torch.launch.flash_probe --variants \
        fp32_shipped fp32_loads_only fp32_no_s fp32_no_exp fp32_no_pv

Builds variants of ``csrc/flash_attn.cu`` into ``build/flash_probe/``, each
the shipped source with one textual patch, and times them with CUDA events,
in turns (every variant, then again in reverse order), beside
``scaled_dot_product_attention``.  A variant whose name starts with
``fp32_`` times the fp32 body (``flash_fwd``) on fp32 inputs at smollm-360m's
prefill layer (B = 4, H = 15, KV = 5, S = 2048, d = 64, causal) and at
phi-3-vision's prefix-check layer (B = 2, H = 32, KV = 32, S = 1024,
d = 96, causal); any other the bf16 body at smollm-360m's layer.

bf16 variants:

* probes, which take one part of the work out and so compute a wrong
  result (their time shows what that part costs): ``no_softmax`` (P is the
  raw scores in bf16, no max, exp, sum or split), ``no_exp``, ``no_p_lo``
  (P_lo = 0, both products kept), ``one_pv`` (P rounded once to bf16 and
  one product: the usual bf16 design), ``no_rescale`` (O is not rescaled
  by alpha), ``no_pv``, ``no_s`` (constant scores), ``loads_only`` (the
  TMA ring and the barriers, no products and no softmax);
* alternatives, which stay correct and are held against the plain
  version: ``bk32`` (32-key tiles at every head dim), ``stages3`` (a
  3-stage ring).

fp32 variants: ``fp32_shipped``; probes ``fp32_loads_only`` (the TMA ring,
its waits and counts: no products, no softmax), ``fp32_no_s`` (constant
scores: no Q K^T), ``fp32_no_softmax`` (P is the raw scores: no max, exp
or rescale; l counts the tiles), ``fp32_no_exp`` (p = x - m in place of
2^(x - m)), ``fp32_no_pv`` (no P V); alternatives ``fp32_2blocks`` (d = 64
in blocks of 4 warps and 32-key tiles, two blocks an SM) and
``fp32_bk64`` (64-key tiles at d = 96: one block an SM there).

Prints one JSON line per variant (``ms`` over both turns, by layer for the
fp32 ones, ``ptxas``) and the card's name and power limit.  Raises without
a card; a patch that no longer matches the source raises too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn.ref import flash_attn_plain

OUT = _build.BUILD_DIR.parent / "flash_probe"

_SOFTMAX_CALL = """    softmax_tile<BK>(s, p, m, l, alpha, edge, q0 + r0 + off, k0 + cq, mk,
                     scale_log2);
"""
_TRIVIAL_P = """    alpha[0] = alpha[1] = 1.f;
    l[0] += 1.f;
    l[1] += 1.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      p.hi[i >> 3][(i >> 1) & 3] = bits(__floats2bfloat162_rn(s[i], s[i + 1]));
      p.lo[i >> 3][(i >> 1) & 3] = 0u;
    }
"""
_S_CALL = "    issue_s<D>(s, q_s, ks);\n"
_CONST_S = """#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.01f * i;
"""
_PV_CALL = "    issue_pv<D>(acc, p, vs);\n"
_P_LO = """    p.lo[i >> 3][(i >> 1) & 3] =
        bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
"""
_NO_P_LO = "    p.lo[i >> 3][(i >> 1) & 3] = 0u * __float_as_uint(hf.x);\n"

_F32_S_CALL = """    if (live) f32_scores<D>(s, q_t, ring + (uk % kSlots) * T::kKVFloats +
                                        tx * LD);
"""
_F32_CONST_S = """    if (live)
#pragma unroll
      for (int i = 0; i < T::kTM; ++i)
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) s[i][j] = 0.01f * (i + j);
"""
_F32_SOFTMAX_CALL = """      if (edge)
        f32_softmax<D, true>(s, acc, m, l, pw, row, k0 + tx, seq_k, causal,
                             has_window, window);
      else
        f32_softmax<D, false>(s, acc, m, l, pw, row, k0 + tx, seq_k, causal,
                              has_window, window);
"""
_F32_PV_CALL = ("      f32_pv<D>(acc, p_t, ring + (uv % kSlots) * T::kKVFloats + "
                "4 * tx);\n")
_F32_RAW_P = """#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        l[i] += 1.f;
#pragma unroll
        for (int j = 0; j < T::kTN; ++j)
          pw[j * T::kTX * T::kLP + i] = s[i][j] + (edge ? row : 0);
      }
"""

# name -> [(old, new), ...]; every ``old`` must occur exactly once
PATCHES = {
    "shipped": [],
    "no_softmax": [(_SOFTMAX_CALL, _TRIVIAL_P)],
    "no_exp": [("fast_exp2(s[i] - m[r])", "(s[i] - m[r])"),
               ("fast_exp2(s[i + 1] - m[r])", "(s[i + 1] - m[r])")],
    "no_p_lo": [(_P_LO, _NO_P_LO)],
    "one_pv": [(_P_LO, _NO_P_LO),
               ("for (int half = 0; half < 2; ++half)",
                "for (int half = 0; half < 1; ++half)")],
    "no_rescale": [("for (int i = 0; i < kO; ++i) acc[c][i] *= "
                    "alpha[(i >> 1) & 1];",
                    "for (int i = 0; i < kO; ++i) (void)alpha;")],
    "no_pv": [(_PV_CALL, "")],
    "no_s": [(_S_CALL, _CONST_S)],
    "loads_only": [(_S_CALL, _CONST_S), (_SOFTMAX_CALL, _TRIVIAL_P),
                   (_PV_CALL, "")],
    "bk32": [("static constexpr int kBK = D <= 128 ? 64 : 32;        "
              "// keys of a tile",
              "static constexpr int kBK = 32;                        "
              "// keys of a tile")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "fp32_shipped": [],
    "fp32_loads_only": [(_F32_S_CALL, _F32_CONST_S), (_F32_SOFTMAX_CALL, ""),
                        (_F32_PV_CALL, "")],
    "fp32_no_s": [(_F32_S_CALL, _F32_CONST_S)],
    "fp32_no_softmax": [(_F32_SOFTMAX_CALL, _F32_RAW_P)],
    "fp32_no_exp": [("fast_exp2(s[i][j] - m_cur)", "(s[i][j] - m_cur)")],
    "fp32_no_pv": [(_F32_PV_CALL, "")],
    "fp32_2blocks": [("kBK = D <= 64 ? 64 : 32;", "kBK = 32;"),
                     ("kWarps = D == 64 ? 8 : 4;", "kWarps = 4;")],
    "fp32_bk64": [("kBK = D <= 64 ? 64 : 32;", "kBK = D <= 96 ? 64 : 32;")],
}
CORRECT = ("shipped", "bk32", "stages3", "fp32_shipped", "fp32_2blocks",
           "fp32_bk64")
SHAPE = (4, 15, 5, 2048, 64)        # B, H, KV, S, d
FP32_SHAPES = {"smollm": SHAPE, "phi3v_prefix": (2, 32, 32, 1024, 96)}


def patched(name: str, source: str) -> str:
    for old, new in PATCHES[name]:
        if source.count(old) != 1:
            raise ValueError(f"flash_probe {name}: patch target occurs "
                             f"{source.count(old)} times: {old!r}")
        source = source.replace(old, new)
    return source


def build(names) -> dict:
    """Compile every variant, one ``nvcc`` each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_attn.cu").read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(patched(name, source))
        so = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_launch.argtypes = [
            vp, vp, vp, vp, *[i32] * 7, *[ctypes.c_longlong] * 12,
            ctypes.c_float, i32, i32, i32, vp]
        lib.flash_attn_launch.restype = i32
        ptxas = [line for line in _build._ptxas_lines(log)
                 if "flash_fwd" in line or "Loss" in line]
        libs[name] = (lib, ptxas)
    return libs


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cases(name: str) -> dict:
    """layer -> (dtype, (B, H, KV, S, d)) a variant is timed at."""
    if name.startswith("fp32_"):
        return {layer: (torch.float32, shape)
                for layer, shape in FP32_SHAPES.items()}
    return {"smollm": (torch.bfloat16, SHAPE)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("flash_probe times the kernel on a CUDA card; "
                           "none is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(args.variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    inputs = {}                         # (layer, dtype) -> q, k, v, limit
    for name in args.variants:
        for layer, (dtype, (B, H, KV, S, d)) in _cases(name).items():
            if (layer, dtype) in inputs:
                continue
            q = torch.randn((B, H, S, d), generator=gen, device="cuda")
            k, v = (torch.randn((B, KV, S, d), generator=gen, device="cuda")
                    for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            want = flash_attn_plain(q.float(), k.float(), v.float(),
                                    causal=True)
            rtol = 2e-4 + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)
            inputs[layer, dtype] = (q, k, v, want, 2e-4 + rtol * want.abs())

    def sdpa_all() -> dict:
        return {f"{layer}_{str(dtype)[6:]}": cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), args.reps)
                for (layer, dtype), (q, k, v, _, _) in inputs.items()}

    share = {}
    saved = flash_kernel._lib
    times = {name: {layer: [] for layer in _cases(name)}
             for name in args.variants}
    sdpa_ms = [sdpa_all()]
    try:
        for name in args.variants + args.variants[::-1]:
            flash_kernel._lib = libs[name][0]
            for layer, (dtype, _) in _cases(name).items():
                q, k, v, want, limit = inputs[layer, dtype]

                def run():
                    return flash_kernel.flash_attn_cuda(q, k, v, causal=True)

                if name in CORRECT and (name, layer) not in share:
                    o = run()
                    torch.cuda.synchronize()
                    share[name, layer] = float(
                        ((o.float() - want).abs() / limit).max())
                    if not share[name, layer] <= 1:
                        raise AssertionError(
                            f"flash_probe {name} at {layer}: "
                            f"{share[name, layer]} of the limit")
                times[name][layer].append(cuda_ms(run, args.reps))
    finally:
        flash_kernel._lib = saved
    sdpa_ms.append(sdpa_all())
    out = {"card": card, "shape": list(SHAPE),
           "fp32_shapes": {k_: list(v_) for k_, v_ in FP32_SHAPES.items()},
           "sdpa_ms": sdpa_ms, "variants": {}}
    for name in args.variants:
        row = {"ms": times[name],
               "mean_ms": {layer: sum(t) / len(t)
                           for layer, t in times[name].items()},
               "ptxas": libs[name][1]}
        shares = {layer: x for (n, layer), x in share.items() if n == name}
        if shares:
            row["share_of_limit"] = shares
        out["variants"][name] = row
        print(json.dumps({"variant": name, **row}), flush=True)
    print(json.dumps({k_: out[k_] for k_ in ("card", "shape", "fp32_shapes",
                                             "sdpa_ms")}), flush=True)
    return out


if __name__ == "__main__":
    main()
