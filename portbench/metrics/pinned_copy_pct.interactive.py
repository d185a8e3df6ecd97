"""Share of the window's frames that reached the host by the pinned route
(app/driver.App._to_host: one stream-ordered copy into page-locked
memory), in %: the program's ``copy_to_host:pinned`` count
(ops/_build.LAUNCHES, as the Run's ``launches`` holds it) over the
window's requests; a program counter.  A program without the counter
gives nothing."""


def read(run):
    pinned = run.launches.get("copy_to_host:pinned")
    if pinned is None or not run.requests:
        return None
    return 100.0 * pinned / run.requests
