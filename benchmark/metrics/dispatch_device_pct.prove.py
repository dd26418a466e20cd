"""dispatch_device_pct.prove: the grouped MSM dispatches' device stage
(`device_s` of `batch_prove.last_timings`: upload, run and download, up
to a sync) as a share of the waves' walls, %."""


def read(run):
    lt = run.counters.get("last_timings") or []
    wave = sum(t["wave_s"] for t in lt)
    return 100.0 * sum(t["device_s"] for t in lt) / wave if wave else None
