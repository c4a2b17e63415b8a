"""Host milliseconds a served frame spends in the serving call, from the call
to its return (before the wait for the card), averaged over the traced
window's requests."""


def read(ctx):
    host = ctx["info"].get("host_s")
    frames = ctx["info"].get("frames")
    if not host or not frames:
        return None
    return 1e3 * sum(host) / frames
