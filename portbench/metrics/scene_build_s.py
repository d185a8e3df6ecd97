"""Seconds of the scene build: TriangleSet.from_arrays, make_world (the
BVH) and get_shader_data; host clock."""


def read(run):
    return run.scene_build_s or None
