#!/usr/bin/env python3
"""Hold one checkout's mlstm_scan to another's, bit for bit, on the card:

    python3 tools/mlstm_parity.py TREE --save OUT.pt
    python3 tools/mlstm_parity.py TREE --against OUT.pt

TREE is the root of a checkout (this one, or an older commit unpacked
with `git archive` into a directory that .gitignore lists). The script
imports that checkout's `repro_torch` and calls its `mlstm_scan` wrapper
without an initial state, with return_state, on fixed inputs drawn on the
card from fixed seeds: xlstm-350m's prefill shape (1, 1024, 4, 512) and a
ragged S = 1000 in bf16 at chunk 64 (the tensor-core path), S 1000 at
chunk 96 (its 128-step tile), the prefill shape in fp32 (the CUDA-core
kernel), the metered window's eval shape (128, 32, 4, 512) in both
dtypes, and two small sweep cases. --save writes h and the state of every
case; --against compares them with a saved file and prints, per case,
whether every output is equal bit for bit (exit 1 if one is not). Run
each tree in its own process.
"""
import argparse
import os
import sys

CASES = [  # (B, S, H, P, dtype, chunk)
    (1, 1024, 4, 512, "bfloat16", 64), (1, 1000, 4, 512, "bfloat16", 64),
    (1, 1000, 4, 512, "bfloat16", 96), (1, 1024, 4, 512, "float32", 64),
    (128, 32, 4, 512, "bfloat16", 64), (128, 32, 4, 512, "float32", 64),
    (2, 96, 3, 16, "float32", 32), (1, 33, 1, 64, "bfloat16", 32)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--save")
    ap.add_argument("--against")
    args = ap.parse_args(argv)
    if bool(args.save) == bool(args.against):
        ap.error("give one of --save and --against")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("mlstm_parity: no CUDA device")
    from repro_torch.kernels import mlstm_scan as mod
    assert os.path.abspath(mod.__file__).startswith(tree), mod.__file__
    dev = torch.device("cuda")
    outs = {}
    for i, (B, S, H, P, dt, chunk) in enumerate(CASES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v = (torch.randn((B, S, H, P), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        ig = (torch.randn((B, S, H), generator=gen, device=dev) * 2).to(dtype)
        fg = (torch.randn((B, S, H), generator=gen, device=dev) * 2
              + 1).to(dtype)
        h, st = mod.mlstm_scan(q, k, v, ig, fg, chunk=chunk,
                               return_state=True)
        outs[f"{B}x{S}x{H}x{P} {dt} chunk {chunk}"] = [
            t.cpu() for t in (h,) + tuple(st)]
    torch.cuda.synchronize()
    if args.save:
        torch.save(outs, args.save)
        print(f"[parity] {tree}: {len(outs)} cases saved to {args.save}")
        return 0
    want = torch.load(args.against)
    bad = 0
    for name, got in outs.items():
        same = all(torch.equal(a, b) for a, b in zip(got, want[name]))
        bad += not same
        print(f"[parity] {name}: h, C, n, m "
              f"{'equal bit for bit' if same else 'DIFFER'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
