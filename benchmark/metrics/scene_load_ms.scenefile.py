"""The command line's own "Scene loading" timer (parse, OBJ load, BVH
and tables), in ms, as it prints it under enableOutput=1: the mean over
the traced calls."""


def read(ctx):
    vals = [r["scene_load_ms"] for r in ctx.records if "scene_load_ms" in r]
    return sum(vals) / len(vals) if vals else None
