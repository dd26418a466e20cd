"""A bucket fold's share of its roofline, from the device trace.

The fold kernels' device time (the repack and the fold, `g1_fold.cuh`)
in the window, against the least time their launches' inputs need: the
field products that write the fold's words (`yardstick.fold_products`,
counted from each launch's plan and bases), 600 32-bit multiplies each,
at the card's integer rate.  Bound by operations; the bytes a fold reads
take far less."""

FOLD_KERNELS = ("g1_fold_kernel", "g1_fold_repack_kernel")


def roofline_pct(run):
    products = run.counters.get("fold_products") or []
    if run.trace is None or run.int_rate is None or not products:
        return None
    fold_s = run.trace.seconds_of(*FOLD_KERNELS)
    if fold_s <= 0:
        return None
    from .yardstick import least_seconds

    need = sum(int(p) for p in products)
    return 100.0 * least_seconds(need, run.int_rate) / fold_s
