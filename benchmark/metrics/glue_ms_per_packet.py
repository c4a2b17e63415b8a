"""Device milliseconds a teacher packet spends outside the field kernel
(sampling, encodings, compositing, copies): the window's other device
operations over its packets (a packet is one coarse and one fine launch)."""


def read(ctx):
    fine = ctx["config"]["netwidth_fine"]
    packets = sum(c for key, c in ctx["b1_shapes"].items() if key[2] == fine)
    if not packets:
        return None
    other = sum(d for name, d in ctx["device"] if "field_kernel" not in name)
    return 1e3 * other / packets
