"""The port's FLOP count against the reference's XLA cost analysis.

For olmo-1b at smoke width (vocabulary 64, batch 8, seq 32) and the keys
that tests/test_torch_roofline.py holds, prints the port's CostTable
FLOPs (matrix products from FlopCounterMode plus the elementwise count),
the reference CostTable's, their ratio, and the elements that XLA's
optimized HLO converts between dtypes in the reference's once-counted
compile of the pass: the share of the reference's count that is XLA's
CPU backend casting bf16 operands to f32 and back.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/roofline_flops_check.py

Runs on the CPU (it imports both packages); ~30 s.
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

KEYS = [("eval", "fp32"), ("prefill", "fp32"), ("train", "fp32"),
        ("train", "bf16"), ("decode", "fp32")]


def converted_elements(hlo: str) -> int:
    """Elements produced by `convert` ops in an HLO module's text, fused
    computations included."""
    n = 0
    for m in re.finditer(r"= \w+\[([\d,]*)\]\S* convert\(", hlo):
        size = 1
        for d in m.group(1).split(","):
            if d:
                size *= int(d)
        n += size
    return n


def main():
    import jax.numpy as jnp
    from torch.utils.flop_counter import FlopCounterMode

    from repro.configs import smoke_config as jsmoke
    from repro.launch import roofline as JR
    from repro_torch.configs import smoke_config
    from repro_torch.launch.roofline import (CostTable, _ArithmeticCounter,
                                             precision_dtype)

    jcfg = dataclasses.replace(jsmoke("olmo-1b"), vocab_size=64)
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=64)
    jt, pt = JR.CostTable(), CostTable()
    for kind, prec in KEYS:
        want = jt.cost(jcfg, batch=8, seq=32, kind=kind, precision=prec)
        got = pt.cost(cfg, batch=8, seq=32, kind=kind, precision=prec)
        cd = jnp.float32 if prec == "fp32" else jnp.bfloat16
        hlo = jt._base_compiled(jcfg, 8, 32, kind, cd).as_text()
        products, rest = FlopCounterMode(display=False), _ArithmeticCounter()
        with products, rest:
            pt._run(pt._model(cfg), 8, 32, kind, precision_dtype(prec))
        print(f"{kind:8s} {prec}: port {got.flops:,.0f} (products "
              f"{products.get_total_flops():,}, elementwise "
              f"{rest.flops:,}), reference {want.flops:,.0f}, port / "
              f"reference {got.flops / want.flops:.4f}; XLA converts "
              f"{converted_elements(hlo):,} elements in the once-counted "
              f"compile")


if __name__ == "__main__":
    main()
