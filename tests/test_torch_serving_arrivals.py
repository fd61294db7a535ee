"""The port's arrival processes against the reference's, on the CPU.

``repro_torch.serving.arrivals`` is a copy of ``repro.serving.arrivals``
(pure numpy): for every process kind, the same numpy seed must give the
same arrival times — and, for ``MultiTenantArrivals.sample_with_classes``,
the same tenant labels — bit for bit, the same derived rates, and the
same refusals of bad parameters.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

from repro.serving import arrivals as RA
from repro_torch.serving import arrivals as TA

CLASSES = (("premium", 1.0), ("standard", 3.0))
CASES = {
    "poisson": ("poisson", 8.0, {}),
    "deterministic": ("deterministic", 3.0, {}),
    "mmpp": ("mmpp", 5.0, {}),
    "mmpp_bursty": ("mmpp", 5.0, dict(burstiness=9.0, burst_fraction=0.1,
                                      mean_cycle=2.5)),
    "trace": ("trace", 1.0, dict(offsets=(0.0, 0.2, 0.25, 1.0, 1.7))),
    "trace_one_point": ("trace", 1.0, dict(offsets=(0.4,))),
    "multitenant": ("multitenant", 12.0, dict(classes=CLASSES)),
    "multitenant_diurnal_burst": ("multitenant", 12.0, dict(
        classes=CLASSES, diurnal_amplitude=0.3, diurnal_period=20.0,
        burst_rate=0.5, burst_size=12, burst_span=0.5)),
    "multitenant_three_classes": ("multitenant", 40.0, dict(
        classes=(("a", 0.2), ("b", 0.5), ("c", 0.3)),
        diurnal_amplitude=0.6, diurnal_period=3.0)),
}


def _pair(kind, rate, kw):
    return (RA.make_arrivals(kind, rate=rate, **kw),
            TA.make_arrivals(kind, rate=rate, **kw))


@pytest.mark.parametrize("n", [1, 7, 500])
@pytest.mark.parametrize("start", [0.0, 3.25])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_is_the_references(case, start, n):
    ref, port = _pair(*CASES[case])
    assert type(port).__name__ == type(ref).__name__
    want = ref.sample(np.random.default_rng(11), n, start=start)
    got = port.sample(np.random.default_rng(11), n, start=start)
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got, want)
    assert port.mean_rate() == ref.mean_rate()


@pytest.mark.parametrize("n", [1, 64, 4_000])
@pytest.mark.parametrize(
    "case", ["multitenant", "multitenant_diurnal_burst",
             "multitenant_three_classes"])
def test_sample_with_classes_is_the_references(case, n):
    ref, port = _pair(*CASES[case])
    rng_r, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for start in (0.0, 100.0):  # a second draw continues the same stream
        wt, wl = ref.sample_with_classes(rng_r, n, start=start)
        gt, gl = port.sample_with_classes(rng_t, n, start=start)
        np.testing.assert_array_equal(gt, wt)
        assert gl == wl
    assert port.class_names == ref.class_names
    assert port.class_shares == ref.class_shares


def test_derived_rates_are_the_references():
    mr, mt = _pair(*CASES["mmpp_bursty"])
    assert mt.state_rates == mr.state_rates
    assert mt.dwell_means == mr.dwell_means
    times = np.array([2.0, 2.5, 4.0, 4.5])
    tr = RA.TraceArrivals.from_times(times)
    tt = TA.TraceArrivals.from_times(times)
    assert tt.offsets == tr.offsets and tt.mean_rate() == tr.mean_rate()


BAD = [
    ("poisson", 0.0, {}), ("poisson", float("inf"), {}),
    ("deterministic", -1.0, {}),
    ("mmpp", 1.0, dict(burstiness=1.0)), ("mmpp", 1.0, dict(burst_fraction=1.0)),
    ("mmpp", 1.0, dict(mean_cycle=0.0)),
    ("trace", 1.0, {}), ("trace", 1.0, dict(offsets=())),
    ("trace", 1.0, dict(offsets=(1.0, 0.5))),
    ("multitenant", 1.0, dict(classes=())),
    ("multitenant", 1.0, dict(classes=(("a", 1.0), ("a", 2.0)))),
    ("multitenant", 1.0, dict(classes=(("a", -1.0),))),
    ("multitenant", 1.0, dict(diurnal_amplitude=1.0)),
    ("multitenant", 1.0, dict(diurnal_period=0.0)),
    ("multitenant", 1.0, dict(burst_rate=-1.0)),
    ("multitenant", 1.0, dict(burst_size=-1)),
    ("multitenant", 1.0, dict(burst_span=0.0)),
    ("gamma", 1.0, {}),
]


@pytest.mark.parametrize("kind,rate,kw", BAD)
def test_bad_parameters_are_refused_as_the_reference_refuses_them(kind, rate,
                                                                  kw):
    with pytest.raises(ValueError) as ref:
        RA.make_arrivals(kind, rate=rate, **kw)
    with pytest.raises(ValueError) as port:
        TA.make_arrivals(kind, rate=rate, **kw)
    assert str(port.value) == str(ref.value)
