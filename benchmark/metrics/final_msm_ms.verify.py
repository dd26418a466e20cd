"""final_msm_ms.verify: the span around the active backend's MSM call
for a batch's final check (it returns a host point, so the span ends
synchronised), less the traced run's own fold probes inside it, ms a
batch."""


def read(run):
    n = run.spans.count("final_msm")
    if not n:
        return None
    return (run.spans.total("final_msm") - run.spans.total("probe")) / n * 1e3
