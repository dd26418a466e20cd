"""`tools/msm_sweep.py` on the CPU at n = 256, held against the JAX
package's `msm_device` on the same seeded inputs (run as
tests/test_msm_device.py runs it on the CPU: the jnp path of its
pipeline) and against the native host MSM.  Points compare after affine
normalization (their compressed encodings): the port's bucket order may
differ from the reference's unstable sort, so projective sums may too.

The JAX pipeline at this shape family takes about a minute to lower and
compile on XLA:CPU (the persistent cache skips the compile on reruns), so
this case has a file of its own and a test worker to itself."""

import json
import random

import torch

from curdleproofs_tpu.host.rng import StdRng as JRng
from curdleproofs_tpu.host.serde import g1_to_bytes as j_g1_to_bytes
from curdleproofs_tpu.ops.msm_device import msm_device as j_msm_device
from curdleproofs_tpu_torch.host import native
from curdleproofs_tpu_torch.host.serde import g1_to_bytes
from curdleproofs_tpu_torch.tools import msm_sweep

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)


def test_sweep_at_256_matches_the_reference_and_the_host(tmp_path):
    out = tmp_path / "out" / "sweep.json"
    assert msm_sweep.main(["8", "--big", "0", "--proxy-logn", "0", "--reps",
                           "1", "--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["match"] is True and art["pool"] == 256
    (row,) = art["rows"]
    assert (row["n"], row["c"]) == (256, 8)
    assert row["warm_ms_ints"] > 0 and row["warm_ms_bytes"] > 0

    # the same inputs, drawn again: the port's and the reference's StdRng
    # give the same points from seed 0, random.Random(1) the same scalars
    pts, ss = msm_sweep.sample(msm_sweep.make_pool(256), 256,
                               random.Random(1))
    jrng = JRng.seed_from_u64(0)
    jpts = [jrng.rand_g1() for _ in range(256)]
    assert [j_g1_to_bytes(p) for p in jpts] == [g1_to_bytes(p) for p in pts]
    want = g1_to_bytes(native.msm(pts, ss)).hex()
    assert row["result"] == want
    assert j_g1_to_bytes(j_msm_device(jpts, ss)).hex() == want
