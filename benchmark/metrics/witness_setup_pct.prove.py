"""witness_setup_pct.prove: the batched prover's witness set-up on the host
(`prove.setup`: the RNG draws, the transcripts and the grand product's
witness up to the IPA's blinders, less its `prove.dispatch` children) as a
share of its waves (`prove.wave`, less the harness's probe time inside),
%."""

import bisect


def _program_spans(run):
    """The program's own spans (`curdleproofs_tpu_torch.utils.trace`) that
    lie inside the harness's window, as (name, start s, end s, attrs) on
    the harness's clock, and the harness's probe spans; None where the
    program records none."""
    try:
        from curdleproofs_tpu_torch.utils import trace

        recs = trace.records()
    except (ImportError, AttributeError):
        return None
    win = [(a, b) for n, a, b in run.spans.records if n == "window"]
    if not recs or not win:
        return None
    w0, w1 = win[0]
    spans = [(r.name, r.t0_ns * 1e-9, r.t1_ns * 1e-9, r.attrs or {})
             for r in recs if w0 <= r.t0_ns * 1e-9 and r.t1_ns * 1e-9 <= w1]
    probes = sorted((a, b) for n, a, b in run.spans.records if n == "probe")
    return (spans, probes) if spans else None


def _probe_s(probes: list, a: float, b: float) -> float:
    """Seconds of the harness's own probe spans (sorted (start, end)
    pairs) inside [a, b]."""
    i, s = bisect.bisect_left(probes, (a,)), 0.0
    while i < len(probes) and probes[i][0] <= b:
        s += probes[i][1] - probes[i][0] if probes[i][1] <= b else 0.0
        i += 1
    return s


STEPS = ("prove.setup",)


def read(run):
    got = _program_spans(run)
    if got is None:
        return None
    spans, probes = got
    wave = sum(b - a - _probe_s(probes, a, b)
               for n, a, b, _ in spans if n == "prove.wave")
    dispatches = [(a, b) for n, a, b, _ in spans if n == "prove.dispatch"]
    own = 0.0
    for name, a, b, _ in spans:
        if name in STEPS:
            own += b - a - sum(y - x for x, y in dispatches
                               if a <= x and y <= b)
    return 100.0 * own / wave if wave > 0 else None
