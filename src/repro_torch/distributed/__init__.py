"""ECCO's fleet distribution, ported from the JAX package's
`distributed/`.

sharding.py — the fleet-row helpers: row-block spans, the device of each
    block, splitting a row array into its blocks, and `BlockRows`, the
    JobBank's slot stack held as one tensor per block; and the model
    half's `mesh_rules` / `batch_pspec` (logical axes onto the production
    mesh).
checkpoint.py — atomic step directories (`save`, `AsyncCheckpointer`,
    `restore`, `restore_job`).
stragglers.py — `StragglerPolicy`: micro-window quotas from measured
    step times.
elastic.py — `FleetElastic` (window-start checkpoints, barriers, mesh
    shrink on device loss) and the mesh-level `ElasticRuntime`.
"""
