"""The metric arithmetic: rates and means over all requests of a window,
the trace's busy time and idle gaps, the compared numbers, the reservoir,
and the roofline from counted work."""

import numpy as np
import pytest

from portbench import costs, harness, reference, spec, trace


def _run(**kw):
    cell = spec.find_cell(kw.pop("cell", "bunny69k.converge"))
    run = harness.Run(cell.name, cell.config, cell.traffic, cell.config["triangles"],
                      samples=64 if cell.traffic["request"] == "progressive" else 1)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rates_take_every_request_of_the_window():
    run = _run(requests=211, window_s=20.25)
    assert spec.reader("samples_per_s")(run) == pytest.approx(211 * 64 / 20.25)
    assert spec.reader("frame_ms_mean")(run) is None
    run = _run(cell="bunny69k.interactive", requests=9000, window_s=20.002)
    assert spec.reader("frame_ms_mean")(run) == pytest.approx(20002 / 9000)
    assert spec.reader("samples_per_s")(run) is None


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# two requests of 100 us; the card busy 10-40 (kernel) and 30-50 (copy)
# in the first, 160-190 in the second; a kernel outside the window
EVENTS = [_x("user_annotation", "pb.request", 0, 100), _x("user_annotation", "pb.drag", 0, 5),
          _x("user_annotation", "pb.render", 5, 95), _x("user_annotation", "pb.frame_fn", 8, 20),
          _x("user_annotation", "pb.request", 120, 100), _x("user_annotation", "pb.render", 125, 95),
          _x("user_annotation", "pb.frame_fn", 125, 10),
          _x("kernel", "void (anonymous namespace)::frame<0, false, 0>(x)", 10, 30),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 30, 20),
          _x("kernel", "void (anonymous namespace)::frame<0, false, 0>(x)", 160, 30),
          _x("kernel", "other", 500, 10)]
# the program's spans inside those requests, a device-side copy of one,
# and ranges outside the window
PROGRAM = [_x("user_annotation", "app.drag", 1, 3), _x("user_annotation", "engine.frame", 8, 19),
           _x("user_annotation", "frame_kernel.call", 9, 1.5), _x("user_annotation", "frame_kernel", 9.5, 0.5),
           _x("user_annotation", "app.copy", 50, 40), _x("user_annotation", "engine.frame", 125, 9),
           _x("user_annotation", "app.copy", 140, 60), _x("gpu_user_annotation", "engine.frame", 10, 30),
           _x("user_annotation", "renderer.pack", -500, 300), _x("user_annotation", "app.copy", 210, 30)]


def test_trace_busy_idle_and_gaps():
    s = trace.reduce_events(EVENTS)
    assert s.requests == 2 and s.window_s == pytest.approx(220e-6)
    assert s.busy_s == pytest.approx(70e-6)
    assert trace.idle_pct(s) == pytest.approx(100 * 150 / 220)
    assert trace.device_seconds(s, trace.FRAME_KERNEL) == pytest.approx(60e-6)
    assert trace.device_seconds(s, trace.COPY_TO_HOST) == pytest.approx(20e-6)
    g = s.gaps_s
    assert g["drag"] == pytest.approx(5e-6)
    assert g["frame_params"] == pytest.approx(3e-6 + 0)   # 5-8 before the first frame fn
    assert g["frame_fn"] == pytest.approx(2e-6 + 10e-6)   # 8-10, 125-135
    assert g["copy"] == pytest.approx(50e-6 + 25e-6 + 30e-6)  # 50-100, 135-160, 190-220
    assert g["loop"] == pytest.approx(20e-6)              # 100-120
    assert sum(g.values()) == pytest.approx(150e-6)
    assert trace.top(g, 2)[0][0] == "copy"
    assert s.spans_s == {} and s.spans_n == {}


def test_program_spans_are_summed_and_charge_no_gap():
    plain, s = trace.reduce_events(EVENTS), trace.reduce_events(EVENTS + PROGRAM)
    assert s[:5] == plain[:5]    # window, busy, requests, device seconds and gaps alike
    assert s.spans_n == {"app.drag": 1, "engine.frame": 2, "frame_kernel.call": 1, "frame_kernel": 1,
                         "app.copy": 2}
    want = {"app.drag": 3e-6, "engine.frame": 28e-6, "frame_kernel.call": 1.5e-6, "frame_kernel": 0.5e-6,
            "app.copy": 100e-6}
    assert s.spans_s.keys() == want.keys()
    for name, seconds in want.items():
        assert s.spans_s[name] == pytest.approx(seconds), name


def test_compare_counts_non_finite_pixels_as_off():
    err = np.zeros((100, 3))
    err[3, 1] = 0.5
    c = harness.compare(err)
    assert c == {"mean_err": pytest.approx(0.5 / 300), "off_share": 0.01, "fine_share": 0.01,
                 "max_err": 0.5}
    err[5, 2] = 0.001
    assert harness.compare(err)["fine_share"] == 0.02 and harness.compare(err)["off_share"] == 0.01
    err[7, 0] = np.nan
    c = harness.compare(err)
    assert c["off_share"] == 0.02 and c["fine_share"] == 0.03 and c["mean_err"] == np.inf
    assert not harness.verdict(c, {"mean_err": 1.0})
    assert harness.verdict({"mean_err": 0.1, "max_err": 9.0}, {"mean_err": 0.2})


def test_reservoir_keeps_a_uniform_sample():
    counts = np.zeros(200)
    for seed in range(400):
        r = harness.Reservoir(5, np.random.default_rng(seed))
        for i in range(200):
            r.offer(i, i)
        assert len(r.items) == 5 and len({i for i, _ in r.items}) == 5
        for i, _ in r.items:
            counts[i] += 1
    # each index is kept with probability 5 / 200: 10 of 400 runs on average
    assert counts.sum() == 2000 and counts.min() >= 1 and counts.max() <= 26
    assert counts[:100].sum() == pytest.approx(1000, rel=0.1)


def test_roofline_and_step_share_from_counted_work():
    work = reference.Work(slabs=1000, tris=400, tris_t=100, tris_u=50)
    run = _run(work=work, checked_rays=500,
               trace=trace.Summary(2.0, 1.9, 20, {"void frame<0>(x)": 1.6}, {}))
    ops = (1000 * 26 + 400 * 17 + 100 * 14 + 50 * 16) * (1024 * 768) / 500
    moved = costs.launch_bytes(run.triangles, 1024, 768, 64) / 64
    bound = max(ops / 67e12, moved / 3.35e12)
    assert run.bound_s_per_sample() == pytest.approx(bound)
    per_sample = 1.6 / (20 * 64)
    assert spec.reader("frame_kernel_roofline")(run) == pytest.approx(100 * bound / per_sample)
    assert spec.reader("step_mfu")(run) == pytest.approx(100 * bound * 20 * 64 / 2.0)
    assert spec.reader("device_idle_pct.converge")(run) == pytest.approx(5.0)
    assert spec.reader("frame_kernel_roofline")(_run()) is None


def test_counters_from_the_stats_rows():
    from shader_ray_tpu_torch.ops.frame_kernel import stats_phases

    phases = stats_phases(3, True, True)
    rows = np.arange(4 * 19).reshape(4, 19)        # 4 tiles, 1 + 3 x 6 columns
    c = harness.counters(rows, phases)
    assert list(c) == ["rays_cast"] + [f"{p}.{k}" for p in ("bounce0", "shadow0", "bounce1", "shadow1",
                                                             "bounce2", "shadow2")
                                        for k in ("node_pops", "leaf_visits", "tri_tests")]
    col = lambda j: sum(19 * t + j for t in range(4))
    assert c["rays_cast"] == col(0)
    assert c["bounce0.node_pops"] == col(1) and c["bounce0.tri_tests"] == col(3)
    assert c["shadow0.leaf_visits"] == col(5) and c["shadow2.tri_tests"] == col(18)
    assert all(type(v) is int for v in c.values())
    assert len(harness.counters(rows[:, :10], stats_phases(3, False, True))) == 10
    with pytest.raises(ValueError):
        harness.counters(rows, stats_phases(2, True, True))
