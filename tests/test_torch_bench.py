"""The port's benchmark, ``python -m torbi_tpu_torch.bench``, on the CPU.

``--quick --gpu cpu`` runs every configuration at tiny sizes on the
kernels' plain versions, in a subprocess that then reports the modules it
loaded: the benchmark imports neither JAX nor torbi_tpu. What is checked
is the benchmark's logic (one JSON line per metric, the metric names of the
repo's ``bench.py``, the headline last), not its figures, which are CPU
figures.
"""
import json
import subprocess
import sys

import pytest

from torbi_tpu_torch import bench

# bench.py's metric names, with files_native_loader in place of
# files_native_packed_loader (the port has no packed layout)
METRICS = (
    'toy_exact_match',
    'decode_call_latency_ms_batch512',
    'timesteps_decoded_per_second_1440_states_batch512',
    'decode_call_latency_ms_batch1_10240_frames',
    'timesteps_per_second_batch1_10240_frames',
    'timesteps_per_second_batch1_10240_frames_serial',
    'batch1_forward_ms', 'batch1_backtrace_ms', 'batch1_pipeline_ms',
    'batch1_e2e_ms', 'batch1_glue_ms', 'batch1_host_ms',
    'timesteps_per_second_batch1_10240_frames_uniform',
    'timesteps_per_second_chunked_4096_frames',
    'timesteps_per_second_chunked_4096_frames_device',
    'files_loader_assembly_bytes_per_s',
    'files_native_loader',
    'timesteps_per_second_files_decode',
    'timesteps_per_second_files_wall',
    'timesteps_per_second_files_device',
)

RUN = (
    'import json, runpy, sys; '
    'sys.argv = ["bench", "--quick", "--gpu", "cpu"]; '
    'runpy.run_module("torbi_tpu_torch.bench", run_name="__main__"); '
    'print(json.dumps([m for m in sys.modules if m == "jax" '
    'or m.startswith("jax.") or m == "torbi_tpu" '
    'or m.startswith("torbi_tpu.")]))')


@pytest.fixture(scope='module')
def quick_run():
    result = subprocess.run(
        [sys.executable, '-c', RUN], capture_output=True, text=True,
        timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    lines = result.stdout.strip().splitlines()
    records = [json.loads(line) for line in lines[:-1]
               if line.startswith('{')]
    return records, json.loads(lines[-1])


def test_quick_run_imports_no_jax(quick_run):
    assert quick_run[1] == []


def test_quick_run_prints_every_metric(quick_run):
    records, _ = quick_run
    names = [record['metric'] for record in records]
    # The headline is printed twice: measured first, and again last
    assert sorted(names) == sorted(
        METRICS + ('timesteps_decoded_per_second_1440_states_batch512',))
    assert names[-1] == bench.HEADLINE
    assert records[-1] == next(
        record for record in records if record['metric'] == bench.HEADLINE)


def test_quick_run_lines(quick_run):
    """Each line names its device; every value is a number; the toy decodes
    exactly and the native loader filled the file batches; only the
    reference's A40 figures are baselines"""
    records, _ = quick_run
    baselines = {None, bench.BASELINE_A40_BATCH1['name'],
                 bench.BASELINE_A40_BATCH512['name']}
    for record in records:
        assert set(record) == {'metric', 'value', 'unit', 'device',
                               'baseline', 'vs_baseline'}
        assert record['device'] == 'cpu'
        assert isinstance(record['value'], float)
        assert not record['unit'].startswith('skipped')
        baseline = record['baseline']
        assert (baseline and baseline['name']) in baselines
    by_name = {record['metric']: record['value'] for record in records}
    assert by_name['toy_exact_match'] == 1.0
    assert by_name['files_native_loader'] == 1.0


def test_budget_skips_with_explicit_lines(monkeypatch, capsys):
    """A budget that cannot fit the chunked and file configurations prints
    a skipped line for each of their metrics and runs nothing"""
    monkeypatch.setenv('BENCH_BUDGET_S', '0')
    bench.main(['--only', 'chunked,files', '--gpu', 'cpu'])
    records = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith('{')]
    assert [record['metric'] for record in records] == [
        'timesteps_per_second_1m_frames_chunked',
        'timesteps_per_second_1m_frames_chunked_device',
        'files_loader_assembly_bytes_per_s', 'files_native_loader',
        'timesteps_per_second_files_decode',
        'timesteps_per_second_files_wall',
        'timesteps_per_second_files_device']
    assert all(record['value'] is None
               and record['unit'] == 'skipped:wall-clock-budget'
               for record in records)


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        bench.main(['--quick'])
    assert exit_info.value.code == 2
