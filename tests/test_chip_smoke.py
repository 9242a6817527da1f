"""chip_smoke.py's checks on the CPU at a tiny size: the kernel phase's
parity (interpret mode), the main path's trace comparison, and its
count of batches the host served."""
import numpy as np

import chip_smoke as cs


def test_kernel_phase_parity_on_cpu():
    """Phase 3 on a 20 kb world: kernel == jnp DP, alignments bit-equal
    to the native min-cost window aligner, never above the 0-1 BFS."""
    genome, _reads, bundle = cs.bench_world(genome_len=20_000, n_reads=4_000)
    _tk, _tj, (score, zeros) = cs.phase_kernel(genome, bundle,
                                               interpret=True, reps=1)
    assert np.isfinite(score) and 0 < zeros < 4_000


def test_main_path_traces_and_batches(tmp_path, capsys):
    """Phase 6 on a 0.14 Mb deployment: device and native traces are
    identical and every batch of the device run is served by the
    device."""
    cs.phase_main_path(str(tmp_path), iters=4, scale=0.05)
    out = capsys.readouterr().out
    assert "'device': 0, 'native': " in out      # the native run
    assert "'overflow': 0}" in out
    assert "itnum traces identical" in out


def test_batch_counter_counts_overflow_as_host(monkeypatch):
    """A cap overflow (fetch() -> (None, n)) is redone on the host by the
    aligner, so the counter books it as ``overflow``, not ``device``."""
    from gaml_tpu.ops.rescore_device import DeviceRescorer

    results = iter([(None, 9000), (("arrays",), 12)])

    def fake(self, seqs, cap):
        return lambda: next(results)

    monkeypatch.setattr(DeviceRescorer, "extend", fake)
    with cs.BatchCounter() as cnt:
        for _ in range(2):
            DeviceRescorer.extend(None, [], cap=4096)()
    assert cnt.counts == {"device": 1, "native": 0, "overflow": 1}
    assert DeviceRescorer.extend is fake   # restored on exit


def test_strip_time():
    line = "itnum 3 temp 0.01 time 00:00:07 new prob -1.0 -1.0 -1.0 len 9"
    assert cs.strip_time([line]) == [
        "itnum 3 temp 0.01 time new prob -1.0 -1.0 -1.0 len 9"]
