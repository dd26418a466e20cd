"""witness_host_pct.prove: the batched prover's host witness code
(`host_other_s` of `batch_prove.last_timings`) as a share of its waves'
walls, %."""


def read(run):
    lt = run.counters.get("last_timings") or []
    wave = sum(t["wave_s"] for t in lt)
    return 100.0 * sum(t["host_other_s"] for t in lt) / wave if wave else None
