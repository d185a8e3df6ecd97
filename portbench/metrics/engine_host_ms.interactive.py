"""Host milliseconds a frame inside the Renderer's frame function
(ops/engine_frame.py: uniforms, jitter, the kernel's wrapper and launch,
the tonemap's launches), over the traced run's untraced requests; host
clock, summed over all of them."""


def read(run):
    if not run.engine_calls:
        return None
    return 1e3 * run.engine_host_s / run.engine_calls
