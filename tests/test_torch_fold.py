"""The observation conversion folded into the banded forward kernels (K1 in
both designs, K4) against torbi_tpu on the CPU.

torbi_tpu's banded kernels take the unconverted observation and convert
each column as they load it (``log_input=False``: the log of a
probability; ``apply_epsilon=True``: ``log(exp(x) + tiny)``); its
dispatcher sends them the raw observation (``fold_obs``). The port's
kernels do the same; on the CPU their plain versions run the conversion's
torch ops first. Held here, as ``tests/test_parity.py::
test_band_kernel_folded_epsilon_conversion`` holds the JAX kernel:

- the plain folded forwards against torbi_tpu's ``viterbi_forward_band``
  in interpret mode with the same flags: posteriors bitwise on log-space
  input; on probability input within 2 ulp (``torch.log`` and ``jnp.log``
  differ by one ulp on some float32 inputs, and a posterior adds one
  converted value per frame to values that already differ), paths bitwise
  (Dirichlet inputs without sub-tiny entries: XLA's CPU runtime flushes a
  subnormal ``exp`` to zero where PyTorch keeps it, ROADMAP.md C);
- ``dispatch.decode`` and ``from_probabilities`` at each ``log_probs`` on
  the banded, auto-chunk and serial batch-1 routes, which hand the kernel
  the raw observation and the flags and never convert it before, and on
  the dense, constant and scan routes, which convert first, as
  torbi_tpu's do; paths bitwise against torbi_tpu (peaked inputs: clear
  margins);
- the memory guard's count of observation copies on each route;
- ``dispatch.kernel_route`` names the kernels ``decode`` launches, on the
  banded, batch-1, window and dense routes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.ops import band as jax_band
from torbi_tpu_torch.ops import autochunk, band, dispatch

from test_autochunk import peaked_case

TINY = np.finfo(np.float32).tiny
STATES, FRAMES, HALFWIDTH = 130, 12, 4


def _round_up(value, multiple):
    return -(-value // multiple) * multiple


def banded_transition(states, halfwidth, floor):
    bins = np.arange(states)
    tri = np.clip(halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]),
                  0, None)
    probs = (tri / tri.sum(axis=1, keepdims=True)).astype(np.float32)
    with np.errstate(divide='ignore'):
        return np.log(probs + (TINY if floor else 0)).astype(np.float32)


def forward_case(batch, floor, log_input, seed=3):
    """Dirichlet observation (probabilities, or their log), banded
    transition, log-Dirichlet initial, ragged lengths"""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(STATES), size=(batch, FRAMES)).astype(
        np.float32)
    obs = probs if not log_input else np.log(probs).astype(np.float32)
    init = np.log(rng.dirichlet(np.ones(STATES)).astype(np.float32))
    bf = np.array([FRAMES, 5, 1][:batch], np.int32)
    return obs, bf, banded_transition(STATES, HALFWIDTH, floor), init


def jax_forward(obs, bf, trans, init, band_tuple, log_input):
    """torbi_tpu's banded kernel in interpret mode with the conversion
    folded in, on dispatch-padded inputs (padding rows and frames hold 1,
    which converts to a finite value either way), cut back"""
    batch, frames, states = obs.shape
    batch_p, frames_p = _round_up(batch, 8), _round_up(frames, 8)
    states_p = _round_up(states, 128)
    obs_p = np.ones((batch_p, frames_p, states), dtype=np.float32)
    obs_p[:batch, :frames] = obs
    bf_p = np.ones(batch_p, dtype=np.int32)
    bf_p[:batch] = bf
    trans_p = np.full((states_p, states_p), -np.inf, dtype=np.float32)
    trans_p[:states, :states] = trans
    init_p = np.full(states_p, -np.inf, dtype=np.float32)
    init_p[:states] = init
    post_seq, _ = jax_band.viterbi_forward_band(
        jnp.asarray(obs_p), jnp.asarray(bf_p), jnp.asarray(trans_p),
        jnp.asarray(init_p), band_tuple, interpret=True, log_input=log_input,
        apply_epsilon=True)
    return np.asarray(post_seq)[:batch, :frames, :states]


FORWARDS = {
    'band_forward': band.viterbi_forward_band,
    'band_forward_wide': band.viterbi_forward_band_wide,
    'band_spread': band.viterbi_forward_band_spread,
}


@pytest.mark.parametrize('floor', [True, False])
@pytest.mark.parametrize('kernel', list(FORWARDS))
@pytest.mark.parametrize('log_input', [True, False])
def test_folded_forward_matches_jax_kernel(log_input, kernel, floor):
    """The plain folded K1 (both designs) and K4 against torbi_tpu's banded
    kernel with the conversion folded in; then the chase on both streams"""
    batch = 1 if kernel == 'band_spread' else 3
    obs, bf, trans, init = forward_case(batch, floor, log_input)
    band_tuple = band.detect_band(torch.from_numpy(trans))
    assert (band_tuple[2] is None) == (not floor)
    expected = jax_forward(obs, bf, trans, init, band_tuple, log_input)
    matrix = band.build_band_matrix(
        torch.from_numpy(trans), band_tuple[0], band_tuple[1])
    post_seq, posterior = FORWARDS[kernel](
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(init),
        band_tuple, matrix, log_input=log_input, apply_epsilon=True)
    if log_input:
        np.testing.assert_array_equal(post_seq.numpy(), expected)
    else:
        np.testing.assert_array_max_ulp(post_seq.numpy(), expected, maxulp=2)
    trans_t = torch.from_numpy(trans)
    bf_t = torch.from_numpy(bf)
    got = dispatch.backtrace_posteriors(post_seq, trans_t, posterior, bf_t)
    expected = torch.from_numpy(expected.copy())
    want = dispatch.backtrace_posteriors(
        expected, trans_t, expected[:, -1].contiguous(), bf_t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_plain_versions_convert_first():
    """Each plain version on unconverted input equals itself on the input
    dispatch.convert makes"""
    obs, bf, trans, init = forward_case(1, True, False)
    band_tuple = band.detect_band(torch.from_numpy(trans))
    matrix = band.build_band_matrix(
        torch.from_numpy(trans), band_tuple[0], band_tuple[1])
    args = (torch.from_numpy(bf), torch.from_numpy(init), band_tuple, matrix)
    raw = torch.from_numpy(obs)
    for fn in (band.band_forward_reference, band.band_spread_reference):
        for log_input, apply_epsilon in ((False, True), (False, False)):
            folded, _ = fn(raw, *args, log_input=log_input,
                           apply_epsilon=apply_epsilon)
            converted, _ = fn(
                dispatch.convert(raw, log_input, apply_epsilon), *args)
            assert torch.equal(folded, converted)


def route_case(route):
    """(observation in log space, batch_frames, transition, initial) of a
    route: peaked rows (clear margins) over a banded, dense or constant
    transition"""
    if route in ('autochunk', 'serial'):
        frames, states = (384, 256) if route == 'autochunk' else (96, 130)
        obs, trans, init = peaked_case(frames, states, halfwidth=5, seed=21)
        return obs, np.array([frames], np.int32), trans, init
    rows = [peaked_case(40, STATES, halfwidth=4, seed=30 + b)
            for b in range(3)]
    obs = np.concatenate([row[0] for row in rows])
    trans, init = rows[0][1], rows[0][2]
    if route == 'dense':
        rng = np.random.default_rng(5)
        trans = np.log(rng.dirichlet(np.ones(STATES), size=STATES)
                       .astype(np.float32) + TINY).astype(np.float32)
    elif route == 'constant':
        trans = np.full((STATES, STATES), np.log(1. / STATES), np.float32)
    return obs, np.array([40, 23, 1], np.int32), trans, init


FOLDED = ('banded', 'autochunk', 'serial')
ROUTES = {
    # route: (the port's forward wrapper, torbi_tpu's backend)
    'banded': ('viterbi_forward_band', 'pallas'),
    'autochunk': ('viterbi_forward_band', 'pallas'),
    'serial': ('viterbi_forward_band_spread', 'pallas'),
    'dense': (None, 'pallas'),
    'constant': (None, 'pallas'),
    'scan': (None, 'xla'),
}


@pytest.fixture
def route_knobs(monkeypatch):
    """Auto-chunking from 128 frames in 48-frame chunks on both packages,
    as tests/test_torch_autochunk.py sets them; the JAX package's default
    frame buckets on the port's copy"""
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(
            package, 'BATCH1_AUTO_CHUNK_MIN_FRAMES', 128, raising=False)
        monkeypatch.setattr(package, 'BATCH1_CHUNK_FRAMES', 48, raising=False)
    monkeypatch.setattr(
        torbi_tpu, 'BAND_KERNEL_LAYOUT', 'stitched', raising=False)
    monkeypatch.setattr(
        autochunk, '_FRAME_BUCKETS', tuple(torbi_tpu.FRAME_BUCKETS))


def spy_conversion(monkeypatch, wrapper_name):
    """Record what the forward wrapper is handed, and every conversion made
    outside it: returns (forward calls, outside conversions)"""
    calls, outside = [], []
    inside = []
    if wrapper_name is not None:
        orig = getattr(band, wrapper_name)

        def wrapper(obs, bf, initial, band_tuple, matrix, *flags):
            calls.append((obs.clone(), flags))
            inside.append(1)
            try:
                return orig(obs, bf, initial, band_tuple, matrix, *flags)
            finally:
                inside.pop()

        monkeypatch.setattr(band, wrapper_name, wrapper)
    convert = dispatch.convert

    def spy(observation, log_input, apply_epsilon):
        if not inside:
            outside.append((log_input, apply_epsilon))
        return convert(observation, log_input, apply_epsilon)

    monkeypatch.setattr(dispatch, 'convert', spy)
    return calls, outside


@pytest.mark.parametrize('log_probs', [True, False])
@pytest.mark.parametrize('route', list(ROUTES))
def test_decode_routes_fold_as_jax(route_knobs, monkeypatch, route,
                                   log_probs):
    """The banded, auto-chunk and serial routes hand the forward kernel the
    raw observation (the chunk rows gathered raw) with the flags and convert
    nothing outside it; the dense, constant and scan routes convert once,
    first. Paths bitwise equal to torbi_tpu's at each log_probs"""
    if route == 'serial':
        for package in (torbi_tpu, torbi_tpu_torch):
            monkeypatch.setattr(package, 'BATCH1_AUTO_CHUNK', False)
    obs, bf, trans, init = route_case(route)
    if not log_probs:
        obs, trans, init = np.exp(obs), np.exp(trans), np.exp(init)
    wrapper_name, jax_backend = ROUTES[route]
    calls, outside = spy_conversion(monkeypatch, wrapper_name)
    got = torbi_tpu_torch.from_probabilities(
        obs, batch_frames=bf, transition=trans, initial=init,
        log_probs=log_probs, gpu='cpu',
        backend='scan' if route == 'scan' else None)
    if route in FOLDED:
        assert outside == []
        assert len(calls) == 1
        handed, flags = calls[0]
        assert flags == (log_probs, True)
        raw = torch.from_numpy(obs)[0]
        if route == 'autochunk':
            # Each chunk row is a raw slice of the sequence
            assert handed.shape[0] >= 4
            assert torch.equal(handed[0], raw[:handed.shape[1]])
        else:
            assert torch.equal(handed, torch.from_numpy(obs))
    else:
        assert outside == [(log_probs, True)]
        assert calls == []
    expected = torbi_tpu.from_probabilities(
        obs, batch_frames=bf, transition=trans, initial=init,
        log_probs=log_probs, backend=jax_backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_kernel_route_passes_flags(monkeypatch):
    """kernel_route's banded forward passes the flags to its wrapper; the
    dense forward takes a converted observation only"""
    obs, bf, trans, init = forward_case(2, True, False)
    trans_t = torch.from_numpy(trans)
    band_tuple = band.detect_band(trans_t)
    seen = []
    orig = band.viterbi_forward_band

    def wrapper(*args):
        seen.append(args[5:])
        return orig(*args)

    monkeypatch.setattr(band, 'viterbi_forward_band', wrapper)
    (name, forward), _ = dispatch.kernel_route(trans_t, band_tuple, 2)
    assert name == 'band_forward'
    raw = torch.from_numpy(obs)
    folded, _ = forward(raw, torch.from_numpy(bf), torch.from_numpy(init),
                        False, True)
    assert seen == [(False, True)]
    converted, _ = forward(dispatch.convert(raw, False, True),
                           torch.from_numpy(bf), torch.from_numpy(init))
    assert seen[-1] == (True, False)
    assert torch.equal(folded, converted)
    (name, dense_forward), _ = dispatch.kernel_route(trans_t, None, 2)
    assert name == 'dense_forward'
    with pytest.raises(ValueError, match='converted'):
        dense_forward(raw, torch.from_numpy(bf), torch.from_numpy(init),
                      False, True)


@pytest.mark.parametrize('route,log_input,apply_epsilon,prepad,copies', [
    ('banded', True, True, False, 1),
    ('banded', False, True, False, 1),
    ('banded', True, True, True, 2),
    ('dense', True, True, False, 2),
    ('scan', False, False, False, 2),
    ('dense', True, False, False, 1),
])
def test_memory_guard_counts_copies(monkeypatch, route, log_input,
                                    apply_epsilon, prepad, copies):
    """The guard counts one observation copy where the kernel converts (or
    nothing converts) and the states are not padded, two where a converted
    or cut copy is made: a budget of exactly one pass over the batch at
    that count decodes whole, a byte less splits it"""
    obs, bf, trans, init = route_case('dense' if route == 'dense'
                                      else 'banded')
    if not log_input:
        obs = np.exp(obs)
    if prepad:
        padded = np.full(obs.shape[:2] + (256,), -np.inf, np.float32)
        padded[..., :STATES] = obs
        obs = padded
    batch, frames, states_in = obs.shape
    row_bytes = frames * (states_in * copies + STATES) * 4
    calls = []
    decode = dispatch.decode

    def spy(*args, **kwargs):
        calls.append(1)
        return decode(*args, **kwargs)

    monkeypatch.setattr(dispatch, 'decode', spy)
    expected = None
    for budget in (batch * row_bytes, batch * row_bytes - 1):
        groups = 1 if budget // row_bytes >= batch else (
            1 + -(-batch // max(1, budget // row_bytes)))
        monkeypatch.setattr(torbi_tpu_torch, 'DECODE_MEMORY_BUDGET', budget)
        calls.clear()
        out = dispatch.decode(
            obs, bf, trans, init, log_input=log_input,
            apply_epsilon=apply_epsilon, finite_observation=True,
            backend='scan' if route == 'scan' else None, device='cpu')
        assert len(calls) == groups
        if expected is None:
            expected = out
        assert torch.equal(out, expected)


def kernel_route_case(batch, frames, states, seed, tiny=TINY, dense=False):
    """A log-Dirichlet observation; a triangular band of half-width 3 over
    log(tiny) (over -inf at ``tiny=0``) or, with ``dense``, a log-Dirichlet
    dense transition; a uniform initial distribution"""
    rng = np.random.default_rng(seed)
    obs = np.log(rng.dirichlet(np.ones(states), size=(batch, frames))
                 .astype(np.float32) + TINY)
    if dense:
        trans = np.log(rng.dirichlet(np.ones(states), size=states)
                       .astype(np.float32) + TINY)
    else:
        trans = banded_transition(states, 3, tiny > 0)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return (torch.from_numpy(obs),
            torch.full((batch,), frames, dtype=torch.int32),
            torch.from_numpy(trans.astype(np.float32)),
            torch.from_numpy(init))


def record_kernel_calls(monkeypatch):
    """Replace each kernel wrapper where dispatch looks it up by one that
    records its launch-counter name; returns the list of names"""
    calls = []
    for module, attr, name in (
            (band, 'viterbi_forward_band', 'band_forward'),
            (band, 'viterbi_forward_band_spread', 'band_spread'),
            (dispatch, 'viterbi_forward_dense', 'dense_forward'),
            (dispatch, 'backtrace_posteriors', 'backtrace'),
            (dispatch, 'backtrace_fused1', 'backtrace_fused1'),
            (dispatch, 'backtrace_window', 'backtrace_window')):
        def wrapper(*args, original=getattr(module, attr), name=name,
                    **kwargs):
            calls.append(name)
            return original(*args, **kwargs)

        monkeypatch.setattr(module, attr, wrapper)
    return calls


@pytest.mark.parametrize('batch, states, tiny, window, dense, expected', [
    (3, 64, TINY, False, False, ('band_forward', 'backtrace')),
    (1, 64, TINY, False, False, ('band_spread', 'backtrace_fused1')),
    (1, 256, 0.0, True, False, ('band_spread', 'backtrace_window')),
    (2, 32, TINY, False, True, ('dense_forward', 'backtrace'))],
    ids=['banded', 'batch1', 'window', 'dense'])
def test_decode_launches_kernel_route(monkeypatch, batch, states, tiny,
                                      window, dense, expected):
    """decode launches the kernels that dispatch.kernel_route names for the
    input, in its order (the window chase needs two 128-state rows). The
    banded routes fold the epsilon step into the forward kernel and convert
    nothing outside it; the dense route converts once, outside K2"""
    obs, bf, trans, init = kernel_route_case(
        batch, 8 if dense else 12, states, seed=5 if dense else 4,
        tiny=tiny, dense=dense)
    if window:
        monkeypatch.setattr(torbi_tpu_torch, 'BACKTRACE_BATCH1_FUSED', False)
        monkeypatch.setattr(torbi_tpu_torch, 'BACKTRACE_BATCH1_WINDOW', True)
    forward = {'band_forward': 'viterbi_forward_band',
               'band_spread': 'viterbi_forward_band_spread'}
    handed, outside = spy_conversion(monkeypatch, forward.get(expected[0]))
    calls = record_kernel_calls(monkeypatch)
    dispatch.decode(obs, bf, trans, init, apply_epsilon=True, device='cpu')
    assert tuple(calls) == expected
    gated = band.gate_band(band.detect_band(trans), init, observation=None,
                           finite_observation=True)
    (forward_name, _), (chase_name, _) = dispatch.kernel_route(
        trans, gated, batch)
    assert (forward_name, chase_name) == expected
    if dense:
        assert gated is None and outside == [(True, True)]
    else:
        assert [flags for _, flags in handed] == [(True, True)]
        assert outside == []
