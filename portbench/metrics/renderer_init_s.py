"""Seconds from the Renderer's construction (the 8-wide pack and the
upload) to the end of the first warm request (the App, the kernel
library's load or build, the first frame); host clock."""


def read(run):
    return run.renderer_init_s or None
