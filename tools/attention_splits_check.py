#!/usr/bin/env python3
"""Hold one checkout's split-KV decode to its plain version where the
combine merges more than 32 splits, so that two commits can be compared
in one call:

    python3 tools/attention_splits_check.py TREE [--repeat N]

TREE is the root of a checkout (this one, or an older commit unpacked
with `git archive` into a directory that .gitignore lists); the script
imports that checkout's `repro_torch`. Decode rows q (1, 1, 8, 128) bf16
over k, v (1, 8192, 1, 128): `plan` gives one block per 64-key split,
128 splits, whose partials the combine kernel's 128 threads weigh. The
combine once kept each split's weight in the slot of another split's
(m, l), read by a thread of another warp; this shows whether that race
moves the output. Prints, per repeat, the largest difference from
`ref.attention_ref` (bf16 tolerance 2e-2); exits 1 if any exceeds it.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--repeat", type=int, default=20)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("attention_splits_check: no CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention, plan
    from repro_torch.kernels.ref import attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for i in range(args.repeat):
        q = torch.randn((1, 1, 8, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((1, 8192, 1, 128), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        pl = plan(q, k, v)
        got = flash_attention(q, k, v).float()
        err = float((got - attention_ref(q, k, v).float()).abs().max())
        worst = max(worst, err)
        print(f"[splits] {tree}: repeat {i}: {pl.path}, {pl.splits} splits "
              f"of {pl.split}: max_abs_err {err:.3e}")
    print(f"[splits] {tree}: largest error {worst:.3e} over {args.repeat} "
          f"repeats (tolerance 2e-2): {'ok' if worst <= 2e-2 else 'FAIL'}")
    return 0 if worst <= 2e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
