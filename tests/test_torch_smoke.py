"""``chip_smoke.py``'s trace check, on the CPU with a fake profiler.

``profile_path`` keeps a trace only when every kernel of the port in it
shows as many launches as the launch counts and at least the device time
of those launches at their bound; otherwise it takes the trace again
with twice the padding, and fails after its last attempt.  Here
``torch.profiler.profile``, ``torch.cuda.synchronize`` and the launch
counts are fakes, so each attempt's trace is whatever the test says.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from repro_torch.kernels import native  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    def __init__(self, key, count, device_us):
        self.key, self.count = key, count
        self.self_device_time_total = device_us
        self.device_type = DeviceType.CUDA


def _fake_profiler(monkeypatch, traces):
    """Each ``profile()`` context is the next trace of ``traces``: a list
    of (kernel name, launches, device microseconds)."""
    made = []

    class Profile:
        def __init__(self, **kwargs):
            self.events = [_Event(*e) for e in traces[len(made)]]
            made.append(kwargs)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            pass

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    counts = {stem: 0 for stem in native.KERNELS}
    counts.update(chain=3, combine=3)
    monkeypatch.setattr(native, "reset_launch_counts", lambda: None)
    monkeypatch.setattr(native, "launch_counts", lambda: dict(counts))
    return made


CHAIN = "void spttn::chain_kernel<float>(float const*, long long)"
COMBINE = "void spttn::combine_kernel<float>(float const*, long long)"
# three launches of each, bound 2.0 ms and 0.1 ms a launch
NEED = {"chain": 6.0, "combine": 0.3}


def test_a_trace_under_its_bound_is_retaken_then_the_run_fails(
        monkeypatch, capsys):
    smoke = _chip_smoke()
    under = [(CHAIN, 3, 5000.0), (COMBINE, 3, 900.0)]    # chain 5 < 6 ms
    made = _fake_profiler(monkeypatch, [under] * 3)
    with pytest.raises(AssertionError, match="no complete trace in 3"):
        smoke.profile_path("MTTKRP cuda fused", lambda: None, 9.0, NEED,
                           pad_s=0.0, attempts=3)
    assert len(made) == 3
    out = capsys.readouterr().out
    assert out.count("retaken for its clock") == 3
    assert "launches" not in out.split("retaken for its")[1].split(":")[0]


def test_a_trace_at_its_bound_is_kept(monkeypatch, capsys):
    smoke = _chip_smoke()
    under = [(CHAIN, 3, 5000.0), (COMBINE, 3, 900.0)]
    lost = [(CHAIN, 2, 7000.0), (COMBINE, 3, 900.0)]      # a launch lost
    good = [(CHAIN, 3, 6500.0), (COMBINE, 3, 300.0)]
    made = _fake_profiler(monkeypatch, [under, lost, good])
    smoke.profile_path("MTTKRP cuda fused", lambda: None, 9.0, NEED,
                       pad_s=0.0, attempts=3)
    assert len(made) == 3
    out = capsys.readouterr().out
    assert "attempt 1 (padding 0.0 s) retaken for its clock" in out
    assert "attempt 2 (padding 0.0 s) retaken for its launches" in out
    assert '"attempts": 3' in out and '"kernel_bound_ms"' in out


def test_sass_counts_find_the_tensor_core_kernels():
    """The build phase's machine-code check: per kernel of the
    ``cuobjdump -sass`` listing, its HGMMA and UTMALDG lines; the bf16
    kernels of K8 and K9 are the ones ``TENSOR_CORE_KERNELS`` names."""
    smoke = _chip_smoke()
    k9 = ("_ZN5spttn17local_attn_kernelILi256EEEv14CUtensorMap_stS1_S1_"
          "iiifP13__nv_bfloat16")
    f32 = "_ZN5spttn17local_attn_kernelIfLi256EEEvPKT_S3_S3_iiifPS1_"
    sass = "\n".join([
        "\t\tFunction : " + f32,
        "        /*0100*/   FFMA R4, R5, R6, R4 ;",
        "\t\tFunction : " + k9,
        "        /*0200*/   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0210*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0220*/   HGMMA.64x256x16.F32.BF16 R24, R152, gdesc[UR8] ;",
    ])
    counts = smoke.sass_counts(sass)
    assert counts == {f32: {"HGMMA": 0, "UTMALDG": 0},
                      k9: {"HGMMA": 2, "UTMALDG": 1}}
    picked = [k for k in counts
              if any(t in k for t in smoke.TENSOR_CORE_KERNELS)]
    assert picked == [k9]

