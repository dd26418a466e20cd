"""replay_ms_per_proof.verify: the host's share of a batch verification
a block: (batch wall - final MSM span) over the blocks, in ms (the
traced run's fold probes lie inside the final MSM span)."""


def read(run):
    calls, msm = run.spans.total("batch"), run.spans.total("final_msm")
    if not run.units or not run.spans.count("final_msm"):
        return None
    return (calls - msm) / run.units * 1e3
