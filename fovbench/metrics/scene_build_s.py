"""Host scene build: seconds of the port's ``build_scene`` in set-up (the
benchmark's clock around the call: flattening, the BVH table from its npz
cache or built, the scene arrays and their upload)."""


def read(ctx):
    return ctx.spans.get("build_scene")
