"""The interval arithmetic of the traced metrics, the roofline's byte
counts and the metric readers, on synthetic events."""

import pytest

from benchmark import harness, roofline, trace


def test_union_and_busy_in():
    assert trace.union_us([]) == 0
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_us([(0, 10), (2, 3)]) == 10
    dev = [(0, 10, "k", "kernel"), (5, 15, "m", "copy"),
           (40, 60, "k", "kernel")]
    # clipped to each span, then summed over the spans
    assert trace.busy_in(dev, [(0, 20), (50, 100)]) == 15 + 10
    assert trace.kernel_us_in(dev, [(0, 20), (50, 100)]) == 10 + 10


def test_gaps_and_their_labels():
    dev = [(10, 20, "k", "kernel"), (15, 30, "k2", "kernel")]
    assert trace.gaps_in(dev, (0, 50)) == [(0, 10), (30, 50)]
    assert trace.gaps_in([], (0, 5)) == [(0, 5)]
    host = sorted([(0, 12, "aten::copy_"), (28, 45, "outer"),
                   (35, 45, "inner")])
    data = trace.TraceData(device=dev, spans={"api.compress": [(0, 50)]},
                           roles={"encode": "api.compress"},
                           host_ops=host)
    labels = trace.label_gaps(data)
    assert labels == [((0, 10), "api.compress / aten::copy_"),
                      ((30, 50), "api.compress / inner")]
    assert data.calls == [(0, 50)] and data.window_s == 50e-6
    assert data.busy_s == pytest.approx(20e-6)
    b = data.breakdown()
    assert b["device_ops"] == [["k2", 15e-6], ["k", 10e-6]]
    assert b["idle_gaps"][0] == ["api.compress / inner", 20e-6]


def test_roofline_bytes():
    assert roofline.encode_bytes(100, 80) == 180
    assert roofline.decode_bytes(80, 100) == 180
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.share_pct(3.35e9, 0.01) == pytest.approx(10.0)
    assert roofline.share_pct(1, 0) is None


def _run(cell_name="markov-64k.host-1m"):
    cell = harness.load_cell(cell_name)
    w = harness.Window()
    w.add(0, 0.5, 0.25, 10**9, 5 * 10**8, 10**9)
    w.add(1, 0.5, 0.75, 10**9, 5 * 10**8, 10**9)
    w.seconds = 2.0
    dev = [(0, 10, "k", "kernel"), (100, 130, "d", "kernel"),
           (130, 140, "Memcpy DtoH", "copy")]
    t = trace.TraceData(device=dev,
                        spans={"api.compress": [(0, 40)],
                               "api.decompress": [(100, 150)]},
                        roles={"encode": "api.compress",
                               "decode": "api.decompress"},
                        host_phases=[{"blockify": {"seconds": 0.001},
                                      "crc32": {"seconds": 0.002},
                                      "container": {"seconds": 0.003},
                                      "h2d": {"seconds": 1.0}}])
    return cell, w, t


def test_metric_readers_on_a_window():
    cell, w, _ = _run()
    run = harness.Run(cell=cell, window=w, setup_s=3.5, peak_bytes=2 * 10**9)
    read = lambda n: harness.load_metric(n).read(run)
    assert read("encode_GBps") == pytest.approx(2.0)
    assert read("decode_GBps") == pytest.approx(2.0)
    assert read("peak_device_GB") == pytest.approx(2.0)
    assert read("setup_s") == 3.5
    assert read("device_idle_share.encode") is None


def test_metric_readers_on_a_trace():
    cell, w, t = _run()
    run = harness.Run(cell=cell, window=w, trace=t)
    read = lambda n: harness.load_metric(n).read(run)
    assert read("device_idle_share.encode") == pytest.approx(0.75)
    assert read("device_idle_share.decode") == pytest.approx(0.2)
    # 3e9 bytes a direction at 3.35 TB/s against 10 and 30 us of kernels
    least = 3e9 / 3.35e12
    assert read("encode_kernels_roofline") == pytest.approx(
        100 * least / 10e-6)
    assert read("decode_kernels_roofline") == pytest.approx(
        100 * least / 30e-6)
    assert read("api_host_ms.compress") == pytest.approx(6.0)
    assert read("encode_GBps") is None


def test_readers_find_nothing_and_return_none():
    cell, w, t = _run()
    empty = trace.TraceData(device=[], spans={"api.compress": [(0, 1)]},
                            roles={"encode": "api.compress"})
    run = harness.Run(cell=cell, window=w, trace=empty)
    for n in ("device_idle_share.encode", "device_idle_share.decode",
              "encode_kernels_roofline", "decode_kernels_roofline",
              "api_host_ms.compress"):
        assert harness.load_metric(n).read(run) is None, n
