"""A/B of two decode-attention kernel sources on the card, in turns old,
new, new, old.

Builds ``--old`` (an earlier ``csrc/decode_attention.cu`` whose C entry
``tp_decode_attention(q, k, v, pos, out, B, H, T, Dh, block, scale,
q_dtype, kv_dtype, stream)`` takes one KV block width, from
:func:`old_block`) into a second library beside the package's own, and
compares the two in one process on one card at every phase 2 decode case
of ``chip_smoke.py`` (``DECODE_CASES``, f32 and bf16 caches): each
kernel's max abs error against the plain version, whether each is
bit-equal across two runs and row by row against the row computed
alone, and the CUDA-event ms of each in turns on the same inputs (the
same cache copies cycled past the 50 MB L2); then the per-step sum of the
serving case (32 calls: one full-depth Llama-3-8B decode step).

Writes the whole result to ``--out`` (JSON) and prints a summary.

Run from the root of a checkout on the card, with the earlier revision's
``csrc/`` extracted into the git-ignored ``_archive/`` (``python -m
torchpruner_tpu_torch.experiments._ab REV``):
``python -m torchpruner_tpu_torch.experiments.decode_ab --old
_archive/REV/decode_attention.cu [--out logs/decode_ab.json]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import sys

from torchpruner_tpu_torch.experiments._ab import ORDER, build_library


def old_block(T: int) -> int:
    """The earlier kernel's KV block: the largest power-of-two divisor of
    T in [8, 128], else 8 (a function of T alone)."""
    from torchpruner_tpu_torch.ops.decode_attention import decode_block

    return decode_block(T) or 8


def old_wrapper(src: str):
    """``decode_attention`` for one-token steps with the kernel of
    ``src`` behind it; the build seconds."""
    import torch

    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.ops import decode_attention as DA

    lib, seconds = build_library(src, "decode_attention_old")
    fn = lib.tp_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def decode_attention(q, k, v, pos):
        B, _, H, Dh = q.shape
        T = k.shape[1]
        qc = q.contiguous()
        pv = DA._pos_vector(pos, B, q.device).contiguous()
        out = torch.empty((B, 1, H, Dh), dtype=v.dtype, device=q.device)
        err = fn(qc.data_ptr(), k.data_ptr(), v.data_ptr(), pv.data_ptr(),
                 out.data_ptr(), B, H, T, Dh, old_block(T),
                 1.0 / math.sqrt(Dh), DA._dtype_code(qc), DA._dtype_code(k),
                 torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "old decode_attention")
        return out

    return decode_attention, seconds


def kernel_cases(dev, kernels) -> list:
    """Phase 2's decode cases, each kernel of ``kernels`` (name ->
    function) checked and timed in turns old, new, new, old."""
    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import decode_attention as DA

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for B, T, H, Dh, positions in CS.DECODE_CASES:
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, 1, H, Dh), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k = torch.randn((B, T, H, Dh), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, T, H, Dh), generator=gen,
                            device=dev).to(dtype)
            want = DA.decode_attention_plain(q, k, v, pos).float()
            errs, stable = {}, {}
            for name, fn in kernels.items():
                got = fn(q, k, v, pos)
                errs[name] = float((got.float() - want).abs().max())
                alone = all(torch.equal(fn(q[b:b + 1], k[b:b + 1],
                                           v[b:b + 1], pos[b:b + 1])[0],
                                        got[b]) for b in range(B))
                stable[name] = alone and bool(
                    torch.equal(fn(q, k, v, pos), got))
            n = CS.copies_for(k.numel() * k.element_size() * 2)
            kvs = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n - 1)]
            times = {name: [] for name in kernels}
            for name in ORDER:
                fn = kernels[name]
                times[name].append(CS.event_ms(
                    lambda i: fn(q, kvs[i % n][0], kvs[i % n][1], pos), 50))
            ratio = statistics.median(times["new"]) \
                / statistics.median(times["old"])
            cases.append({"B": B, "T": T, "H": H, "Dh": Dh,
                          "cache_dtype": str(dtype).replace("torch.", ""),
                          "pos": list(positions),
                          "plan": dict(zip(("chunk", "n_split"),
                                           DA.decode_plan(T))),
                          "old_block": old_block(T), "max_abs_err": errs,
                          "bit_stable": stable, "ms": times,
                          "new_over_old": ratio})
            print(f"  B={B} T={T:<5d} H={H:<2d} cache={dtype}: old "
                  f"{times['old'][0]:.4f}/{times['old'][1]:.4f} new "
                  f"{times['new'][0]:.4f}/{times['new'][1]:.4f} ms "
                  f"({ratio:.3f}x)  err old {errs['old']:.3g} new "
                  f"{errs['new']:.3g}  bit-stable {stable}", flush=True)
            del kvs, k, v
    torch.cuda.empty_cache()
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="an earlier kernel source beside its own revision's "
                         "headers (_archive/REV/NAME.cu, from python -m "
                         "torchpruner_tpu_torch.experiments._ab REV)")
    ap.add_argument("--out", default="logs/decode_ab.json")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as CS
    from torchpruner_tpu_torch.ops import _build
    from torchpruner_tpu_torch.ops import decode_attention as DA

    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = CS.smi_line()
    info = _build.build(["decode_attention"])["decode_attention"]
    old, old_s = old_wrapper(args.old)
    print(f"card: {smi}; built new {info['seconds']:.2f} s, old "
          f"{old_s:.2f} s", flush=True)
    cases = kernel_cases(dev, {"old": old, "new": DA.decode_attention})
    # one full-depth Llama-3-8B decode step: 32 calls of the serving case
    step = next(c for c in cases if c["T"] == CS.DECODE_CASES[0][1]
                and c["cache_dtype"] == "bfloat16")
    step_ms = {k: [CS.DEPTH * t for t in step["ms"][k]] for k in step["ms"]}
    print(f"  decode step (bf16, {CS.DEPTH} calls): old "
          + "/".join(f"{t:.3f}" for t in step_ms["old"]) + " new "
          + "/".join(f"{t:.3f}" for t in step_ms["new"]) + " ms", flush=True)
    result = {"card": smi, "cases": cases, "step_ms": step_ms}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"card": smi, "step_ms": step_ms, "new_over_old": {
        f"T{c['T']}_{c['cache_dtype']}": c["new_over_old"] for c in cases}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
