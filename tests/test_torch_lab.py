"""The port's kernel labs against the JAX labs.

Every forward lab variant that the port takes (the JAX lab's build_kernel,
build_kernel_tilted and build_kernel_spread variants) and every chase lab
variant: the port's plain versions on the CPU against the JAX labs run in
interpret mode, bitwise. The JAX kernel lab is loaded by path with
``KERNEL_LAB_INTERPRET=1`` set before import; the JAX chase lab has no
such switch, so its ``pallas_call`` is replaced by one with
``interpret=True`` while it builds. Inputs are the labs' own, from seed 0:
8 x 16 x 256 at widths 5 and 44 for the forward lab, 256 frames x 1536
states for the chase lab (whose tree12 and two_trees variants read the
TPU's column order, so the port gets the columns permuted to states).
"""
import functools
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torbi_tpu_torch.scripts import chase_lab, kernel_lab

SCRIPTS = Path(__file__).resolve().parent.parent / 'scripts'
BATCH, FRAMES, STATES = 8, 16, 256
CHASE_FRAMES, CHASE_STATES = 256, 1536

FORWARD = ('full', 'loopk', 'rowadd', 'pipe', 'pipe8', 'ushare', 'ushare2',
           'rollmax', 'addmax', 'max', 'vregroll')
TILTED = ('tilted', 'introt', 'subroll')


def load_script(name, module_name):
    spec = importlib.util.spec_from_file_location(
        module_name, SCRIPTS / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def jax_kernel_lab():
    saved = os.environ.get('KERNEL_LAB_INTERPRET')
    os.environ['KERNEL_LAB_INTERPRET'] = '1'
    try:
        return load_script('kernel_lab', 'jax_kernel_lab_interpret')
    finally:
        if saved is None:
            del os.environ['KERNEL_LAB_INTERPRET']
        else:
            os.environ['KERNEL_LAB_INTERPRET'] = saved


@pytest.fixture(scope='module')
def jax_chase_lab():
    return load_script('chase_lab', 'jax_chase_lab')


def lab_case(width):
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((BATCH, FRAMES, STATES)).astype(np.float32)
    band = rng.standard_normal(
        (-(-width // 8) * 8, STATES)).astype(np.float32)
    return obs, band


def port_forward(variant, obs, band, width):
    return kernel_lab.lab_forward(
        variant, torch.from_numpy(obs), torch.from_numpy(band),
        width).numpy()


@pytest.mark.parametrize('width', [5, 44])
@pytest.mark.parametrize('variant', FORWARD)
def test_forward_variant_equals_jax(jax_kernel_lab, variant, width):
    """Row 9 of the kernel table: build_kernel's variants"""
    obs, band = lab_case(width)
    expected = np.asarray(jax_kernel_lab.build_kernel(
        variant, BATCH, FRAMES, STATES, width)(
            jnp.asarray(obs), jnp.asarray(band)))
    np.testing.assert_array_equal(
        port_forward(variant, obs, band, width), expected)


@pytest.mark.parametrize('width', [5, 44])
@pytest.mark.parametrize('variant', TILTED)
def test_tilted_variant_equals_jax(jax_kernel_lab, variant, width):
    """Row 11: build_kernel_tilted's variants, through the JAX lab's tilted
    layout"""
    obs, band = lab_case(width)
    blocks = STATES // 128
    out = np.asarray(jax_kernel_lab.build_kernel_tilted(
        variant, BATCH, FRAMES, STATES, width)(
            jnp.asarray(jax_kernel_lab.tilt_obs(obs, blocks)),
            jnp.asarray(jax_kernel_lab.tilt_band(band, width, blocks))))
    expected = jax_kernel_lab.untilt_posterior(out, BATCH, STATES)
    np.testing.assert_array_equal(
        port_forward(variant, obs, band, width), expected)


@pytest.mark.parametrize('width', [5, 44])
def test_spread_equals_jax(jax_kernel_lab, width):
    """Row 14: build_kernel_spread on sequence 0, band rows past the width
    at -inf as the JAX lab's check sets them; both equal row 0 of full"""
    obs, band = lab_case(width)
    band[width:] = -np.inf
    fn, _ = jax_kernel_lab.build_kernel_spread(FRAMES, STATES, width, band)
    expected = jax_kernel_lab.unspread_posterior(np.asarray(fn(
        jnp.asarray(jax_kernel_lab.spread_obs(obs[0], STATES)), None)),
        STATES)
    got = kernel_lab.lab_spread(
        torch.from_numpy(obs[0]), torch.from_numpy(band), width).numpy()
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, port_forward('full', obs, band,
                                                    width)[0])


def test_spread_sync_is_max_function():
    """The barrier probe computes max's function, obs + post, on one
    sequence, at either cluster size"""
    obs, band = lab_case(5)
    expected = np.cumsum(obs[0], axis=0, dtype=np.float32)[-1]
    for cluster in kernel_lab.CLUSTERS:
        got = kernel_lab.lab_spread(
            torch.from_numpy(obs[0]), torch.from_numpy(band), 5, cluster,
            sync_only=True).numpy()
        np.testing.assert_array_equal(got, expected)


def test_circular_edges_differ_from_clipped():
    """The lab wraps its sources around the states; K1's recursion clips
    them. With finite band rows the edges differ, the middle does not"""
    from torbi_tpu_torch.ops import band as band_ops

    width = 5
    obs, band = lab_case(width)
    lo = -(width // 2)
    circular = port_forward('full', obs, band, width)
    # band_forward_reference reads band[d, j] for the source j + d + lo,
    # -inf where that source falls outside the states
    j = np.arange(STATES)[None, :]
    d = np.arange(width)[:, None]
    clipped_band = np.where((j + d + lo >= 0) & (j + d + lo < STATES),
                            band[:width], -np.inf).astype(np.float32)
    clipped = band_ops.band_forward_reference(
        torch.from_numpy(obs), torch.full((BATCH,), FRAMES,
                                          dtype=torch.int32),
        torch.zeros(STATES), (lo, width, None),
        torch.from_numpy(clipped_band))[1].numpy()
    assert not np.array_equal(circular[:, :2], clipped[:, :2])
    assert FRAMES < STATES // 2
    middle = slice(FRAMES * width, STATES - FRAMES * width)
    np.testing.assert_array_equal(circular[:, middle], clipped[:, middle])


@pytest.mark.parametrize('variant', list(chase_lab.VARIANTS))
def test_chase_variant_equals_jax(jax_chase_lab, monkeypatch, variant):
    """Row 15: chase_lab._build's final index, at 256 frames x 1536 states"""
    monkeypatch.setattr(
        pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(0)
    trans = rng.normal(size=(CHASE_STATES, CHASE_STATES)).astype(np.float32)
    post = rng.normal(size=(CHASE_FRAMES, CHASE_STATES)).astype(np.float32)
    expected = int(np.asarray(jax_chase_lab._build(variant, CHASE_FRAMES)(
        jnp.asarray(trans), jnp.asarray(post)))[0, 0])
    if variant in chase_lab.ROW_VARIANTS:
        # Stored column c holds state (c % 128) * M + c // 128
        column = np.arange(CHASE_STATES)
        state = (column % 128) * (CHASE_STATES // 128) + column // 128
        natural_trans, natural_post = (np.empty_like(trans),
                                       np.empty_like(post))
        natural_trans[:, state] = trans
        natural_post[:, state] = post
        trans, post = natural_trans, natural_post
    for threads in chase_lab.THREAD_SHAPES:
        got = chase_lab.lab_chase(
            variant, torch.from_numpy(trans), torch.from_numpy(post),
            threads)
        assert got.dtype == torch.int32 and got.tolist() == [expected]


@pytest.mark.parametrize('spec', [
    'pipe0', 'full:3', 'tilted:1', 'spread:4', 'full:4:3', 'nonesuch'])
def test_bad_specs_raise(spec):
    with pytest.raises(ValueError):
        kernel_lab.parse_spec(spec)


@pytest.mark.parametrize('width', [5, 44])
@pytest.mark.parametrize('variant', ['pipe3', 'pipe5'])
def test_pipe_any_group_equals_jax(jax_kernel_lab, variant, width):
    """pipeG for a G without an instance of its own (the run-time group
    of csrc/lab_pipe.cu): parses at every n_acc and batch tile, and its
    plain version equals the JAX lab's variant of the same name"""
    group = int(variant[4:])
    assert kernel_lab.pipe_group(variant) == group
    assert kernel_lab.parse_spec(f'{variant}:2:8') == (variant, 2, 8)
    assert kernel_lab.function_of(variant) == 'full'
    obs, band = lab_case(width)
    expected = np.asarray(jax_kernel_lab.build_kernel(
        variant, BATCH, FRAMES, STATES, width)(
            jnp.asarray(obs), jnp.asarray(band)))
    np.testing.assert_array_equal(
        port_forward(variant, obs, band, width), expected)
    np.testing.assert_array_equal(
        kernel_lab.lab_pipe(variant, torch.from_numpy(obs),
                            torch.from_numpy(band), width, 1, 1).numpy(),
        expected)


def test_labs_run_on_cpu_when_asked():
    """The command lines run end to end on the CPU (the plain versions)"""
    results = kernel_lab.main([
        '--device', 'cpu', '--batch', '8', '--frames', '8', '--states',
        '256', '--width', '5', '--iters', '1', '--variants',
        'full:1:8,tilted:2,introt:8:1,spread,spread_sync:16'])
    assert list(results['results']) == [
        'full:1:8', 'tilted:2', 'introt:8:1', 'spread', 'spread_sync:16']
    assert results['ideals']['candidates'] == 8 * 7 * 256 * 5
    # Each spec's output is its function's on the returned inputs
    obs, band = results['inputs']
    outputs = results['outputs']
    assert torch.equal(outputs['tilted:2'],
                       kernel_lab.forward_reference('full', obs, band, 5))
    assert torch.equal(outputs['introt:8:1'],
                       kernel_lab.forward_reference('introt', obs, band, 5))
    assert torch.equal(outputs['spread'],
                       kernel_lab.spread_reference(obs[0], band, 5))
    assert torch.equal(outputs['spread_sync:16'], kernel_lab.spread_reference(
        obs[0], band, 5, sync_only=True))
    chases = chase_lab.main([
        '--device', 'cpu', '--frames', '128', '--states', '1024',
        '--iters', '1', '--threads', '32,192', '--variants',
        ','.join(chase_lab.VARIANTS)])
    assert set(chases['results']) == {
        'scalar_only', 'scalar_nomod', 'v2s_floor', 'v2s_nomod', 'tree1',
        'tree12@32', 'tree12@192', 'two_trees@32', 'two_trees@192',
        'two_trees_nomod@32', 'two_trees_nomod@192'}
    trans, post = chases['inputs']
    for label, row in chases['results'].items():
        assert row['index'] == chase_lab.chase_reference(
            label.split('@')[0], trans, post)
    with pytest.raises(SystemExit) as done:
        kernel_lab.main(['--device', 'cpu', '--batch', '8', '--frames', '8',
                         '--states', '256', '--width', '5', '--check'])
    assert done.value.code == 0
    with pytest.raises(SystemExit) as done:
        kernel_lab.main(['--device', 'cpu', '--frames', '8', '--states',
                         '256', '--width', '5', '--check-spread'])
    assert done.value.code == 0


def test_labs_need_a_card_by_default(monkeypatch):
    """Without CUDA the labs raise unless asked for the CPU"""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        kernel_lab.main(['--iters', '1'])
    with pytest.raises(RuntimeError):
        chase_lab.main(['--iters', '1'])
