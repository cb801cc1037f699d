"""The port's tensor-core forward lab (mxushift, hybrid:K) and the pipeG
groups against the JAX lab.

The port's plain versions on the CPU against the JAX lab's
``build_kernel_mxushift`` and ``build_kernel('pipeG')`` run in interpret
mode (``KERNEL_LAB_INTERPRET=1`` set before the JAX lab is loaded by path),
at the lab's inputs from seed 0, 8 x 16 x 256 states, widths 5 and 44.
Every comparison is bitwise (tolerance: none): each candidate is one fp32
add and the max does not depend on order. The helpers the CUDA kernel
rests on (the bf16 split, the residue partition, the mma count) are pinned
here too, since the kernel itself runs only on the card.
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
            'jax_kernel_lab_mxu_interpret', SCRIPTS / 'kernel_lab.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        if saved is None:
            del os.environ['KERNEL_LAB_INTERPRET']
        else:
            os.environ['KERNEL_LAB_INTERPRET'] = saved


def lab_case(width, states=STATES):
    obs, band = kernel_lab.lab_inputs(BATCH, FRAMES, states, width, 'cpu')
    return obs.numpy(), band.numpy()


@pytest.mark.parametrize('width', [5, 44])
@pytest.mark.parametrize('n_acc', [1, 4])
def test_mxushift_equals_jax(jax_kernel_lab, n_acc, width):
    """Row 10 of the kernel table: build_kernel_mxushift, every residue on
    the MXU, against lab_mxu's plain version (bitwise)"""
    obs, band = lab_case(width)
    expected = np.asarray(jax_kernel_lab.build_kernel_mxushift(
        BATCH, FRAMES, STATES, width, n_acc)(
            jnp.asarray(obs), jnp.asarray(band)))
    got = kernel_lab.lab_mxu(torch.from_numpy(obs), torch.from_numpy(band),
                             width, n_acc)
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('width', [5, 44])
@pytest.mark.parametrize('k', [1, 3])
def test_hybrid_equals_jax(jax_kernel_lab, k, width):
    """hybrid:K, K residues on the MXU and the rest rolled (bitwise)"""
    obs, band = lab_case(width)
    expected = np.asarray(jax_kernel_lab.build_kernel_mxushift(
        BATCH, FRAMES, STATES, width, 4, mxu_k=k)(
            jnp.asarray(obs), jnp.asarray(band)))
    got = kernel_lab.lab_mxu(torch.from_numpy(obs), torch.from_numpy(band),
                             width, mxu_k=k)
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('scale', [1e-3, 1.0, 1e2, 1e4])
def test_split_bf16x3_reconstructs(scale):
    """(hi + mid) + lo gives back every value bitwise: normals scaled 1e-3
    to 1e4, both signs, each part a bf16 value"""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        200_000).astype(np.float32) * np.float32(scale))
    hi, mid, lo = kernel_lab.split_bf16x3(x)
    for part in (hi, mid, lo):
        assert torch.equal(part, part.to(torch.bfloat16).float())
    assert torch.equal((hi + mid) + lo, x)
    assert (x < 0).any() and (x > 0).any()


def test_split_bf16x3_reconstructs_lab_posteriors():
    """The same on what the kernel splits: the lab's posteriors at 1536
    states, frame by frame (bitwise)"""
    obs, band = kernel_lab.lab_inputs(16, 64, 1536, 175, 'cpu')
    for frames in (1, 2, 8, 64):
        post = kernel_lab.forward_reference(
            'full', obs[:, :frames], band, 175)
        hi, mid, lo = kernel_lab.split_bf16x3(post)
        assert torch.equal((hi + mid) + lo, post)


def test_mxu_residues_at_pitch_width():
    """The JAX lab's partition at 1536 states, width 175: 128 lane-residue
    classes, 81 with one candidate and 47 with two; hybrid:81 takes
    exactly the singles, hybrid:K the first K of them"""
    classes, mxu = kernel_lab.mxu_residues(1536, 175)
    sizes = [len(group) for _, group in classes]
    assert len(classes) == 128 and mxu == {u for u, _ in classes}
    assert sizes.count(1) == 81 and sizes.count(2) == 47
    singles = [u for u, group in classes if len(group) == 1]
    assert kernel_lab.mxu_residues(1536, 175, 81)[1] == set(singles)
    assert kernel_lab.mxu_residues(1536, 175, 8)[1] == set(singles[:8])
    assert kernel_lab.mxu_offsets(1536, 175, 81).sum() == 81
    assert kernel_lab.mxu_offsets(1536, 175).all()
    # The classes hold every offset once, each at its roll amount
    offsets = sorted(d for _, group in classes for d, _ in group)
    assert offsets == list(range(175))
    for u, group in classes:
        for d, s in group:
            assert s == (87 - d) % 1536 and s % 128 == u


def test_mma_count_at_pitch_width():
    """3 mmas per (tile, offset), 6 where the 8 sources straddle two
    16-state blocks (7 of every 16 residues): 2,373,525,504 for mxushift
    at 512 x 512 x 1536, width 175; hybrid counts only its offsets"""
    assert kernel_lab.mxu_mma_count(512, 512, 1536, 175) == 2_373_525_504
    per_tile = [3 * (1 + ((j0 - 87 + d) % 16 > 8))
                for j0 in range(0, 1536, 8) for d in range(175)]
    assert sum(per_tile) * 32 * 511 == 2_373_525_504
    assert kernel_lab.mxu_mma_count(17, 2, 1536, 175) == 2 * sum(per_tile)
    assert 0 < kernel_lab.mxu_mma_count(512, 512, 1536, 175, 8) < (
        kernel_lab.mxu_mma_count(512, 512, 1536, 175, 81))
    assert kernel_lab.mxu_mma_count(512, 512, 1536, 175, 0) == 0


@pytest.mark.parametrize('variant', ['pipe2', 'pipe4', 'pipe16'])
def test_pipe_groups_equal_jax(jax_kernel_lab, variant):
    """Row 9's pipeG: the groups 2, 4, 16 parse and equal the JAX lab's
    pipeG and full (bitwise)"""
    width = 44
    obs, band = lab_case(width)
    assert kernel_lab.parse_spec(f'{variant}:2:8') == (variant, 2, 8)
    assert kernel_lab.FUNCTIONS[variant] == 'full'
    expected = np.asarray(jax_kernel_lab.build_kernel(
        variant, BATCH, FRAMES, STATES, width)(
            jnp.asarray(obs), jnp.asarray(band)))
    got = kernel_lab.lab_forward(variant, torch.from_numpy(obs),
                                 torch.from_numpy(band), width)
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(
        got.numpy(), kernel_lab.lab_forward(
            'full', torch.from_numpy(obs), torch.from_numpy(band),
            width).numpy())


@pytest.mark.parametrize('spec', ['pipe00', 'pipe-1', 'mxushift:3',
                                  'mxushift:4:8', 'hybrid:-1'])
def test_bad_mxu_and_pipe_specs_raise(spec):
    """pipe takes any group of 1 or more; mxushift's second field is n_acc
    and its CTA holds the mma's 16 sequences; K is 0 or more"""
    with pytest.raises(ValueError):
        kernel_lab.parse_spec(spec)


def test_mxushift_needs_states_multiple_of_128():
    """1440 states (the port's default) is not a multiple of 128: the MXU
    variants raise, from the wrapper and from the command line"""
    obs, band = kernel_lab.lab_inputs(8, 4, 1440, 5, 'cpu')
    for k in (None, 3):
        with pytest.raises(ValueError, match='multiple of 128'):
            kernel_lab.lab_mxu(obs, band, 5, mxu_k=k)
    with pytest.raises(ValueError, match='multiple of 128'):
        kernel_lab.main(['--device', 'cpu', '--batch', '8', '--frames', '4',
                         '--variants', 'full,mxushift'])


def test_lab_runs_new_variants_on_cpu():
    """The command line runs mxushift, hybrid, pipeG, mod12 and mod12k on
    the CPU (the plain versions) and returns each output in its layout"""
    results = kernel_lab.main([
        '--device', 'cpu', '--batch', '8', '--frames', '6', '--states',
        '256', '--width', '5', '--iters', '1', '--variants',
        'mxushift:8,hybrid:3,pipe16:1:2,mod12:2:8,mod12k'])
    obs, band = results['inputs']
    outputs = results['outputs']
    full = kernel_lab.forward_reference('full', obs, band, 5)
    for spec in ('mxushift:8', 'hybrid:3', 'pipe16:1:2'):
        assert torch.equal(outputs[spec], full)
    assert torch.equal(
        kernel_lab.unmod12_posterior(outputs['mod12:2:8'], 8, 256), full)
    assert torch.equal(outputs['mod12k'][0], outputs['mod12:2:8'])
    assert torch.equal(outputs['mod12k'][1], full)
    rows = results['results']
    assert rows['mxushift:8']['mma_instructions'] == (
        kernel_lab.mxu_mma_count(8, 6, 256, 5))
    assert rows['hybrid:3']['tensor_core_candidates'] == 8 * 5 * 256 * 3
    assert rows['hybrid:3']['shared_load_candidates'] == 8 * 5 * 256 * 2
    assert rows['mod12k']['stitched_pairs'] == len(
        kernel_lab.mod12_stitched(band, 5)[0])
