"""ssd_busy_pct.p95: the share of the profiled stretch's busy device time
spent in ssd_scan's device functions (`bench/kernels/ssd_scan.py`); None
where the stretch ran none of them."""
from bench.core import spec


def read(run):
    st = run.stretch
    if st is None or st.busy_s <= 0:
        return None
    n, dev_s = st.device_s(spec.kernel("ssd_scan").DEVICE_NAMES)
    return 100.0 * dev_s / st.busy_s if n else None
