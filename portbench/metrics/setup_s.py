"""Set-up seconds: process start to the window's first request (imports,
card start, scene generation, build and pack, upload, the kernel
library's load, the warm-up requests); host clock."""


def read(run):
    return run.setup_s or None
