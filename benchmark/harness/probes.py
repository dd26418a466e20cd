"""Spans and counters the harness puts around calls into the program's
layers, from outside the program: nothing of the program is edited."""

from __future__ import annotations

import hashlib
import inspect

from .yardstick import ONE_MONT, Q, _packed_col, fold_products


def sub_seed(seed: int, tag: str) -> int:
    """A 64-bit seed for one purpose, drawn from the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def span_method(obj, name: str, spans, span_name: str):
    """Wrap `obj.<name>` (a module's function, a class's method or static
    method, an instance's attribute) in a span."""
    orig = getattr(obj, name)

    def wrapped(*args, **kwargs):
        with spans.span(span_name):
            return orig(*args, **kwargs)

    static = isinstance(inspect.getattr_static(obj, name), staticmethod)
    setattr(obj, name, staticmethod(wrapped) if static else wrapped)
    return orig


def install_fold_probe(ctx) -> None:
    """In a traced run, count the least work of every bucket-fold launch
    in the window (`yardstick.fold_products`) under
    `ctx.counters["fold_products"]`, as device scalars read after the
    window.  The count runs on a stream of its own inside a `probe` span,
    so it delays none of the program's work, and the trace's reduction
    leaves its device operations out (`trace.read_trace`)."""
    if not ctx.traced:
        return
    import torch

    from curdleproofs_tpu_torch.ops import msm_device, msm_grouped

    out = ctx.counters.setdefault("fold_products", [])
    side = {}
    if ctx.device == "cuda":
        # the stream and the count's constant columns, made before the window
        dev = torch.device("cuda", torch.cuda.current_device())
        side[dev] = torch.cuda.Stream(device=dev)
        for v in (ONE_MONT, Q - ONE_MONT):
            _packed_col(v, dev)

    def count(ext_px, ext_py, ext_zb, plan, madd):
        dev = plan.device
        if dev.type != "cuda":
            return fold_products(ext_px, ext_py, ext_zb, plan, madd)
        if dev not in side:
            side[dev] = torch.cuda.Stream(device=dev)
        stream = side[dev]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            need = fold_products(ext_px, ext_py, ext_zb, plan, madd)
        for t in (ext_px, ext_py, ext_zb, plan):
            t.record_stream(stream)
        return need

    for mod in (msm_device, msm_grouped):
        for name, madd in (("g1_fold_madd", True), ("g1_fold_packed", False)):
            orig = getattr(mod, name)

            def wrapped(ext_px, ext_py, ext_zb, plan, _orig=orig, _madd=madd):
                res = _orig(ext_px, ext_py, ext_zb, plan)
                if ctx.spans.enabled:
                    with ctx.spans.span("probe"):
                        out.append(count(ext_px, ext_py, ext_zb, plan, _madd))
                return res

            setattr(mod, name, wrapped)


def point_affine(p) -> tuple[int, int] | None:
    """(x, y) of a host point (the program's or the reference's type:
    Jacobian ints x, y, z), None at infinity."""
    if p.z == 0:
        return None
    from .yardstick import Q

    zi = pow(p.z, -1, Q)
    zi2 = zi * zi % Q
    return p.x * zi2 % Q, p.y * zi2 * zi % Q
