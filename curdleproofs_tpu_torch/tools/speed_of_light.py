"""Marginal rates of the fq_mul and g1_add kernels against the card's
integer bound (`bench.py`'s speed-of-light block, in the JAX package).

    python3 curdleproofs_tpu_torch/tools/speed_of_light.py --out PATH
        [--logn L] [--chains K1 K2] [--trials T]

At n = 2^logn lanes (default 2^16) a chain of K dependent launches
(y = fq_mul(y, x); for g1_add, p = g1_add(p, q)) is captured in one CUDA
graph and replayed between two CUDA events, so host gaps and the launch
floor drop out; the two-point marginal (t(K2) - t(K1)) / (K2 - K1), with
K1, K2 = 32, 256 by default, is one launch's device time.  Each trial
times both chains back to back; the rate is the median of `--trials`
(default 5) marginals, and the spread the least and the most.

The bound is the card's own, as `PERF.md` counts it: 132 SMs x 64 32-bit
multiplies a clock x the SM's maximum clock (16.73 T/s at 1980 MHz), a
Montgomery product 300 32 x 32 -> 64 products (600 multiplies), a complete
add 12 products.  (The reference's VPU model of a TPU does not carry
over.)  On the CPU the chains run the plain versions, timed on the host
clock: no device rate.  `match`: the kernel's chain equals the plain
version's chain.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time

import torch

if __package__ in (None, ""):   # run by its path: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from curdleproofs_tpu_torch.tools import common  # noqa: E402

FQ_MUL_PER_G1_ADD = 12


def chain_ms(step, start, k: int, device: torch.device) -> float:
    """ms of `k` dependent `step`s from `start`: captured in one CUDA graph
    and replayed once between two events on a card (`common.graph_ms`),
    the host clock on the CPU."""
    def run():
        y = start
        for _ in range(k):
            y = step(y)
        return y

    if device.type == "cuda":
        return common.graph_ms(run, per_graph=1, replays=1)
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) * 1e3


def marginal(step, start, chains, trials, device) -> tuple[float, list]:
    """Median and [least, most] of `trials` two-point marginals, ms a
    launch."""
    k1, k2 = chains
    ests = []
    for _ in range(trials):
        t1 = chain_ms(step, start, k1, device)
        t2 = chain_ms(step, start, k2, device)
        ests.append(max(t2 - t1, 1e-9) / (k2 - k1))
    return statistics.median(ests), [min(ests), max(ests)]


def main(argv: list[str]) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("--logn", type=int, default=16)
    ap.add_argument("--chains", type=int, nargs=2, default=[32, 256])
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    device = common.device_of(args)

    from curdleproofs_tpu_torch.host.rng import StdRng
    from curdleproofs_tpu_torch.ops import kernels as K
    from curdleproofs_tpu_torch.ops.g1_ops import PointsXYZ, points_to_device

    n = 1 << args.logn
    rng = StdRng.seed_from_u64(5)
    pool = [rng.rand_g1() for _ in range(min(n, 1024))]
    p = points_to_device([pool[i % len(pool)] for i in range(n)], device)
    q = points_to_device([pool[(i + 3) % len(pool)] for i in range(n)],
                         device)
    x = K.g1_add(p, q).x.contiguous()       # general Montgomery residues

    # the kernels' short chains against the plain versions' (array equality)
    k = 3
    ok = True
    for step, plain, start in (
            (lambda y: K.fq_mul(y, x), lambda y: K.fq_mul_plain(y, x), x),
            (lambda v: K.g1_add(v, q), lambda v: K.g1_add_plain(v, q), p)):
        a, b = start, start
        for _ in range(k):
            a, b = step(a), plain(b)
        pairs = zip(a, b) if isinstance(a, PointsXYZ) else [(a, b)]
        ok = ok and all(torch.equal(u, v) for u, v in pairs)

    mul_ms, mul_spread = marginal(lambda y: K.fq_mul(y, x), x, args.chains,
                                  args.trials, device)
    add_ms, add_spread = marginal(lambda v: K.g1_add(v, q), p, args.chains,
                                  args.trials, device)
    art = {"tool": "speed_of_light", "n": n, "chains": args.chains,
           "trials": args.trials,
           "estimator": f"median of {args.trials} two-point marginals",
           "fq_mul_ms": mul_ms, "fq_mul_ms_spread": mul_spread,
           "g1_add_ms": add_ms, "g1_add_ms_spread": add_spread,
           "match": ok}
    if device.type == "cuda":
        rate = common.int_rate(device)
        mul_sol = rate / common.MUL32_PER_FQ_MUL
        add_sol = mul_sol / FQ_MUL_PER_G1_ADD
        art.update({
            "int_mul32_per_s": rate,
            "fq_mul_per_s": n / (mul_ms / 1e3),
            "fq_mul_per_s_spread": [n / (mul_spread[1] / 1e3),
                                    n / (mul_spread[0] / 1e3)],
            "fq_mul_pct_of_sol": 100 * n / (mul_ms / 1e3) / mul_sol,
            "g1_add_per_s": n / (add_ms / 1e3),
            "g1_add_per_s_spread": [n / (add_spread[1] / 1e3),
                                    n / (add_spread[0] / 1e3)],
            "g1_add_pct_of_sol": 100 * n / (add_ms / 1e3) / add_sol,
            "sol_model": (f"{rate / 1e12:.2f} T 32-bit multiplies/s (SMs x "
                          f"{common.IMAD_PER_CLK_PER_SM} x max SM clock); "
                          f"fq_mul {common.MUL32_PER_FQ_MUL}, g1_add "
                          f"{FQ_MUL_PER_G1_ADD * common.MUL32_PER_FQ_MUL} "
                          f"multiplies")})
    print(json.dumps(common.write(args.out, art, device)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
