"""A kernel's share of its roofline: the least time its traced calls
could take on the card (``perfbench.work``: the larger of bytes over the
memory rate and operations over the rate of its units) over the device
time of the operations those calls launched, from the device trace."""


def share(ctx, kernel: str):
    t = ctx.trace
    least = ctx.values.get("least_s", {}).get(kernel)
    if t is None or not least:
        return None
    dev = t.by_span.get(f"kernel.{kernel}")
    if not dev:
        return None
    return 100.0 * least / dev
