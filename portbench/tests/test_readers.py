"""The per-layer readers on a made-up stretch."""

from pathlib import Path

import pytest

from portbench.harness import families, reader
from portbench.trace import Trace, base_name

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def read(name, trace):
    ctx = type("Ctx", (), dict(trace=trace, cfg={"units": 140, "window_size": 12,
                                                 "multi_layer": 5, "stack_cnt": 2,
                                                 "horizon": 3, "compute_dtype": "float32"},
                               training=name.endswith(".train"), peak=495e12,
                               families=families()))
    return reader(name).read(ctx)


def stretch():
    kernels = [("void (anonymous namespace)::spectral_chain_kernel<float, 4>(float const*)",
                0.0, 40.0),
               ("void at::native::vectorized_elementwise_kernel<4, float>(int)", 50.0, 60.0),
               ("gru_fwd_cluster_kernel(float const*)", 60.0, 80.0),
               ("cheb_graph_conv_tf32_kernel", 90.0, 100.0)]
    ops = kernels + [("Memcpy HtoD (Pageable -> Device)", 30.0, 45.0)]
    return Trace(ops=ops, kernels=kernels, units=2, batches=[32, 32],
                 host=[("portbench.train.dispatch", 0.0, 100.0),
                       ("cudaStreamSynchronize", 82.0, 95.0)])


def test_base_names():
    assert base_name("void ns::spectral_chain_kernel<float, 4>(float const*)") == \
        "spectral_chain_kernel"
    assert base_name("spectral_dx_kernel(float const*, float*)") == "spectral_dx_kernel"
    assert base_name("ampere_sgemm_128x64_nn") == "ampere_sgemm_128x64_nn"
    assert base_name("void (anonymous namespace)::gru_bwd_grid_kernel<8>(float const*)") == \
        "gru_bwd_grid_kernel"


def test_idle_busy_and_gaps():
    t = stretch()
    assert t.busy_s() == pytest.approx(85e-6)  # [0, 45], [50, 80], [90, 100]
    assert t.window_s == pytest.approx(100e-6)
    assert read("device_idle.train", t) == pytest.approx(15.0)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["portbench.train.dispatch > cudaStreamSynchronize", pytest.approx(10e-6)]


def test_library_ms_leaves_out_the_ports_kernels():
    # only the ATen kernel (10 us) over 2 units
    assert read("library_ms.train", stretch()) == pytest.approx(0.005)


def test_a_metric_of_each_kind_is_read_by_its_familys_file():
    assert reader("step_mfu.train") is not reader("step_mfu.forecast")
    assert reader("step_mfu.train").__file__ == str(METRICS / "step_mfu.py")
    t = stretch()
    train, forecast = read("step_mfu.train", t), read("step_mfu.forecast", t)
    assert train == pytest.approx(3 * forecast)  # 3x the forward a step


def test_no_family_kernel_no_roofline():
    t = Trace(ops=[("x_kernel", 0.0, 1.0)], kernels=[("x_kernel", 0.0, 1.0)], units=1,
              batches=[32])
    assert read("spectral_roofline.train", t) is None
    assert read("gru_roofline.forecast", t) is None
