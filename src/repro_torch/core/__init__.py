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
"""
