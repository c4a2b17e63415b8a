"""Rays the serving kernel was given (what `compact_rays` kept, in whole
packets, by its launches' shapes) as a share of the requests' rays."""


def read(ctx):
    rays = ctx["info"].get("rays")
    launched = sum(key[4] * count for key, count in ctx["b2_shapes"].items())
    if not rays or not launched:
        return None
    return 100.0 * launched / rays
