"""Engine (``engine/engine.py``, ``launch/serve.py``): percent of the
requests served in the traced window that the engine re-ran on the host
after a capacity overflow on the card, from the server's counters
``server_host_fallback`` over ``server_served`` in the engine's registry.
Nothing when the window served no request."""


def read(ctx):
    c = ctx.values.get("counters", {})
    if not c.get("server_served"):
        return None
    return 100.0 * c.get("server_host_fallback", 0) / c["server_served"]
