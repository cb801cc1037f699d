"""The port's mod-M forward lab (mod12, mod12k) against the JAX lab.

The port's own copies of the JAX lab's plan and layout helpers
(``build_mod12_plan``, ``mod12_obs``, ``unmod12_posterior``) and the plain
versions of the two kernels (``mod12_reference``, ``mod12k_reference``) on
the CPU, against the JAX lab's ``build_kernel_mod12`` and
``build_kernel_mod12k`` run in interpret mode (``KERNEL_LAB_INTERPRET=1``
set before the JAX lab is loaded by path), at the lab's inputs from seed
0, 8 x 16 x 256 states, widths 5 and 44. Every comparison is bitwise
(tolerance: none): the stitched plan covers each candidate once, each
candidate is one fp32 add, and the max does not depend on order.
"""
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torbi_tpu_torch.scripts import kernel_lab

SCRIPTS = Path(__file__).resolve().parent.parent / 'scripts'
BATCH, FRAMES, STATES = 8, 16, 256


@pytest.fixture(scope='module')
def jax_kernel_lab():
    saved = os.environ.get('KERNEL_LAB_INTERPRET')
    os.environ['KERNEL_LAB_INTERPRET'] = '1'
    try:
        spec = importlib.util.spec_from_file_location(
            'jax_kernel_lab_mod_interpret', SCRIPTS / 'kernel_lab.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        if saved is None:
            del os.environ['KERNEL_LAB_INTERPRET']
        else:
            os.environ['KERNEL_LAB_INTERPRET'] = saved


def lab_case(width, states=STATES):
    return kernel_lab.lab_inputs(BATCH, FRAMES, states, width, 'cpu')


@pytest.mark.parametrize('states, width', [(256, 5), (256, 44), (1536, 175)])
def test_plan_equals_jax(jax_kernel_lab, states, width):
    """The port's build_mod12_plan has the JAX plan's keys and, row for
    row, its matrices without the 8-sublane repeat (bitwise)"""
    band = np.random.default_rng(2).standard_normal(
        (-(-width // 8) * 8, states)).astype(np.float32)
    expected = jax_kernel_lab.build_mod12_plan(states, width, band)
    got = kernel_lab.build_mod12_plan(states, width, band)
    assert sorted(got) == sorted(expected)
    M = states // 128
    for key, mat in expected.items():
        rows = mat.reshape(M, 8, 128)
        assert (rows == rows[:, :1]).all()
        np.testing.assert_array_equal(got[key], rows[:, 0])
    keys, stitched = kernel_lab.mod12_stitched(torch.from_numpy(band), width)
    assert keys == sorted(expected) and stitched.shape == (len(keys), M, 128)
    if (states, width) == (1536, 175):
        # 186 pairs over 17 distinct lane rotates
        assert len(keys) == 186 and len({alpha for alpha, _ in keys}) == 17


def test_layout_helpers_equal_jax(jax_kernel_lab):
    """mod12_obs and unmod12_posterior move the same values as the JAX
    lab's (bitwise), and undo each other"""
    obs, _ = lab_case(5, 512)
    got = kernel_lab.mod12_obs(obs, 512)
    np.testing.assert_array_equal(
        got.numpy(), jax_kernel_lab.mod12_obs(obs.numpy(), 512))
    post = got[:, :, 3].reshape(-1, 128)
    np.testing.assert_array_equal(
        kernel_lab.unmod12_posterior(post, BATCH, 512).numpy(),
        jax_kernel_lab.unmod12_posterior(post.numpy(), BATCH, 512))
    assert torch.equal(kernel_lab.unmod12_posterior(post, BATCH, 512),
                       obs[:, 3])


@pytest.mark.parametrize('width', [5, 44])
def test_mod12_reference_equals_jax(jax_kernel_lab, width):
    """Row 12: build_kernel_mod12 on the mod-M observation against
    mod12_reference and lab_mod12 on CPU tensors; un-permuted, both equal
    full (bitwise)"""
    obs, band = lab_case(width)
    fn, pairs = jax_kernel_lab.build_kernel_mod12(
        BATCH, FRAMES, STATES, width, band.numpy())
    expected = np.asarray(fn(
        jnp.asarray(jax_kernel_lab.mod12_obs(obs.numpy(), STATES)), None))
    keys, stitched = kernel_lab.mod12_stitched(band, width)
    assert len(keys) == pairs
    obs_mod = kernel_lab.mod12_obs(obs, STATES)
    got = kernel_lab.mod12_reference(obs_mod, stitched, keys)
    np.testing.assert_array_equal(got.numpy(), expected)
    assert torch.equal(kernel_lab.lab_mod12(obs_mod, stitched, keys), got)
    full = kernel_lab.forward_reference('full', obs, band, width)
    assert torch.equal(kernel_lab.unmod12_posterior(got, BATCH, STATES), full)


@pytest.mark.parametrize('width', [5, 44])
def test_mod12k_reference_equals_jax(jax_kernel_lab, width):
    """Row 13: build_kernel_mod12k's two outputs (the mod-M and the natural
    posterior) against mod12k_reference and lab_mod12k (bitwise)"""
    obs, band = lab_case(width)
    out_mod, out_natural = jax_kernel_lab.build_kernel_mod12k(
        BATCH, FRAMES, STATES, width, band.numpy())(
            jnp.asarray(obs.numpy()), None)
    keys, stitched = kernel_lab.mod12_stitched(band, width)
    got_mod, got_natural = kernel_lab.mod12k_reference(obs, stitched, keys)
    np.testing.assert_array_equal(got_mod.numpy(), np.asarray(out_mod))
    np.testing.assert_array_equal(got_natural.numpy(),
                                  np.asarray(out_natural))
    wrapped = kernel_lab.lab_mod12k(obs, stitched, keys)
    assert torch.equal(wrapped[0], got_mod)
    assert torch.equal(wrapped[1], got_natural)


def test_mod_layout_needs_states_multiple_of_128():
    """At 1440 states (M would not be whole) the plan, the wrappers and the
    command line raise, as the JAX lab cannot run there either"""
    obs, band = kernel_lab.lab_inputs(8, 4, 1440, 5, 'cpu')
    with pytest.raises(ValueError, match='multiple of 128'):
        kernel_lab.build_mod12_plan(1440, 5, band.numpy())
    with pytest.raises(ValueError, match='multiple of 128'):
        kernel_lab.mod12_stitched(band, 5)
    keys, stitched = kernel_lab.mod12_stitched(band[:, :1408], 5)
    with pytest.raises(ValueError, match='multiple of 128'):
        kernel_lab.lab_mod12k(obs, stitched, keys)
    for variant in ('mod12', 'mod12k'):
        with pytest.raises(ValueError, match='multiple of 128'):
            kernel_lab.main(['--device', 'cpu', '--batch', '8', '--frames',
                             '4', '--variants', variant])
    with pytest.raises(ValueError, match='multiple of 128'):
        kernel_lab.main(['--device', 'cpu', '--check-mod12'])


def test_mod_layout_needs_batch_multiple_of_8():
    """The mod-M layout groups 8 sequences; other batches raise, as does
    a stitched band of another shape"""
    obs, band = kernel_lab.lab_inputs(12, 4, 256, 5, 'cpu')
    keys, stitched = kernel_lab.mod12_stitched(band, 5)
    with pytest.raises(ValueError, match='multiple of 8'):
        kernel_lab.lab_mod12k(obs, stitched, keys)
    with pytest.raises(ValueError, match='stitched'):
        kernel_lab.lab_mod12k(obs[:8], stitched[1:], keys)
    assert kernel_lab.parse_spec('mod12k:8:2') == ('mod12k', 8, 2)
    with pytest.raises(ValueError):
        kernel_lab.parse_spec('mod12:4:16')


def test_stitch_collision_asserts():
    """The plan keeps the JAX lab's assertion that one offset owns each
    (key, row) stripe: two offsets with the same shift collide"""
    band = np.zeros((8, 256), np.float32)
    plan = kernel_lab.build_mod12_plan(256, 5, band)
    # Every (offset, row) candidate is owned once: 5 offsets x 2 rows
    owned = sum(int(np.isfinite(mat[:, 0]).sum()) for mat in plan.values())
    assert owned == 5 * 2
    with pytest.raises(AssertionError, match='stitch collision'):
        kernel_lab.build_mod12_plan(256, 257 + 5, np.zeros((264, 256),
                                                          np.float32))


def test_check_mod12_on_cpu(capsys):
    """--check-mod12 holds mod12 and mod12k against full and prints the
    JAX lab's two JSON lines"""
    with pytest.raises(SystemExit) as done:
        kernel_lab.main(['--device', 'cpu', '--batch', '8', '--frames', '8',
                         '--states', '256', '--width', '44',
                         '--check-mod12'])
    assert done.value.code == 0
    lines = capsys.readouterr().out.splitlines()
    assert '{"mod12_bitwise_match": true, "stitched_pairs": 45}' in lines
    assert '{"mod12k_bitwise_match": true}' in lines
