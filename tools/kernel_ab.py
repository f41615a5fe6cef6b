#!/usr/bin/env python3
"""Time one checkout's ssd_scan and fleet_drift kernels on the card, so
that two commits can be compared in one call:

    python3 tools/kernel_ab.py TREE --label NAME [--repeat N]

TREE is the root of a checkout (this one, or an older commit unpacked
with `git archive` into a directory that .gitignore lists). The script
imports that checkout's `chip_smoke.py`, and through it that checkout's
`repro_torch`, and uses only what both have kept: the kernels' public
wrappers and chip_smoke's input makers and timers. Run it once per tree
and process, in turns (parent, change, change, parent). It prints, per
repeat, ms per call (CUDA events, 50 calls after warm-up, inputs rotated
past L2) and ms on the device (torch.profiler, every kernel a call
launches) for:

  * ssd_scan at hymba-1.5b's prefill shape, x (1, 1152, 50, 64) bf16,
    N 16, chunk 64, final state out;
  * fleet_drift at the drift plane's (100000, 256) int32 tokens against
    (100000, 64) fp32 references: the plane's bigram tokens at vocab 64,
    and uniform tokens over olmo-1b's 50,304 at vocab 50,304 and at
    vocab 0 (modulo hashing).
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--label", default=None)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    sys.path.insert(0, tree)
    import chip_smoke as c  # the tree's own; exits without a card
    import numpy as np
    import torch
    from repro_torch.kernels.fleet_drift import fleet_drift
    from repro_torch.kernels.ssd_scan import ssd_scan

    assert os.path.dirname(os.path.abspath(c.__file__)) == tree, c.__file__
    print(f"[ab] {label}: {tree}; {c.nvidia_smi()}")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=c.DEV).manual_seed(7)
    ssd_sets = [c._ssd_inputs(1, c.HY_S, 50, 64, 16, bf16, gen)
                for _ in range(10)]

    def ssd(*a):
        return ssd_scan(*a, chunk=c.SSD_CHUNK, return_state=True)

    _, wins = c.drift_fleet()
    plane = [torch.as_tensor(w.astype(np.int32), device=c.DEV)
             for w in wins[1:]]
    rng = np.random.default_rng(12)
    N, T = plane[0].shape
    uniform = [torch.as_tensor(rng.integers(0, c.OLMO_VOCAB, size=(N, T),
                                            dtype=np.int32), device=c.DEV)
               for _ in range(3)]
    refs = torch.as_tensor(rng.random((N, c.BUCKETS), dtype=np.float32),
                           device=c.DEV)
    cases = [("ssd_scan hymba prefill bf16 chunk 64", ssd, ssd_sets)]
    for name, toks, vocab in (("plane bigram tokens", plane, c.DRIFT_VOCAB),
                              ("uniform tokens", uniform, c.OLMO_VOCAB),
                              ("uniform tokens", uniform, 0)):
        def fd(t, r, vocab=vocab):
            return fleet_drift(t, r, buckets=c.BUCKETS, vocab=vocab)
        cases.append((f"fleet_drift ({N},{T}) {name}, vocab {vocab}", fd,
                      [(t, refs) for t in toks]))
    for rep in range(args.repeat):
        for name, fn, sets in cases:
            ms = c._time_ms(fn, sets)
            dev = c._device_ms(fn, sets)
            print(f"[ab] {label} repeat {rep}: {name}: {ms:.4f} ms per call, "
                  f"{dev:.4f} ms on the device")


if __name__ == "__main__":
    main()
