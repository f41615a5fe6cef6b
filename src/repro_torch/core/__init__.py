"""ECCO's decision planes, ported module by module from the JAX package.

rows.py — the dense id -> row registry every fleet plane sizes against.
drift.py — JS-divergence drift detection over token histograms; the
    fleet detector screens with the `fleet_drift` kernel and decides in
    float64 on the host.
signature_index.py — dense fleet arrays answering "which jobs pass the
    prefilter and are drift-signature-similar", with the `pairwise_js`
    kernel behind the top-k shortlist.
grouping.py — Alg. 2 dynamic grouping (metadata prefilter + accuracy
    check; periodic eviction with EMA-smoothed reference).
batching.py — the duck-typed probe for a batched training engine.
trainer.py — the training plane: `TokenRingPool`, the stacked `JobBank`,
    `SharedEngine` (batched evals and micro-windows) and `RetrainJob`.
gaimd.py — the GAIMD fluid model, a host fp32 loop.
transmission.py — §3.2: the profiled sampling-config table and the
    fleet transmission plane (GAIMD bandwidth, batched decisions).
allocator.py — Alg. 1 GPU allocation and its RECL / uniform baselines.
controller.py — the window loop: drift -> grouping -> transmission ->
    allocation -> regrouping -> metrics.
baselines.py — the naive / Ekya / RECL frameworks and `FRAMEWORKS`.
"""
