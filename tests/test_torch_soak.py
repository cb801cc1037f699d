"""A seeded slice of the port's randomized cross-route soak
(``torbi_tpu_torch/scripts/soak.py``) through the kernels' plain versions:
every path equals the port's own oracle. The soak and the evaluation
modules import neither JAX nor torbi_tpu."""
import subprocess
import sys

import pytest

import torbi_tpu_torch
from torbi_tpu_torch.scripts import soak


@pytest.mark.parametrize('seed', [424242, 7])
def test_soak_slice(seed):
    switches = {name: getattr(torbi_tpu_torch, name)
                for name in soak.SWITCHES}
    result = soak.run(cases=15, seed=seed, device='cpu', verbose=False)
    assert result['failures'] == []
    assert sum(result['kinds'].values()) == 15
    assert {name: getattr(torbi_tpu_torch, name)
            for name in soak.SWITCHES} == switches


def test_soak_covers_every_kind():
    import numpy as np

    rng = np.random.default_rng(424242)
    cases = [soak.make_case(rng) for _ in range(60)]
    assert {case['kind'] for case in cases} == {
        'dense', 'band', 'bandfloor', 'const', 'ties', 'wide'}
    assert any(case['padded'] for case in cases)
    assert any(not case['log_probs'] for case in cases)
    assert any((case['bf'] > case['frames']).any() for case in cases)


def test_imports_no_jax():
    code = (
        'import sys, torbi_tpu_torch\n'
        'import torbi_tpu_torch.scripts.soak, torbi_tpu_torch.scripts.eval_synth\n'
        'import torbi_tpu_torch.evaluate.__main__ as _\n'
        'import torbi_tpu_torch.data.download.core, '
        'torbi_tpu_torch.data.preprocess.core\n'
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'torbi_tpu' or m.startswith('torbi_tpu.')]\n"
        'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120)
