"""pYIN's voiced/unvoiced HMM (``models/pyin.py``) through the port's
dense route, on the CPU.

At the published size the port's HMM equals the benchmark's plain
reference (``benchmark/reference/pyin.py``) and librosa's construction.
At a small size (C3-C5 in half semitones: 49 pitch bins, 98 states) a
decode of probabilities through ``from_probabilities(...,
log_probs=False)`` -- the band gate declines, then the conversion pass,
K2's and K3's plain versions -- gives bitwise the paths of the benchmark's
reference decode and of torbi_tpu's oracle on the same log-space inputs:
with ties that the first source must win, with -inf transition and
initial entries, and with the transition's orientation mattering. The
conversion's span and counters fire once on such a decode and never on
the banded routes. The port's paths of the same probabilities equal
torbi_tpu's from_probabilities(..., log_probs=False) bitwise.
"""
import numpy as np
import pytest
import torch
from scipy.signal import windows

import torbi_tpu_torch
from benchmark import inputs, pyin as pyin_inputs
from benchmark.reference import pyin as reference
from benchmark.reference import viterbi as reference_viterbi
import torbi_tpu
from torbi_tpu.ops.oracle import viterbi_numpy
from torbi_tpu_torch.models import pyin
from torbi_tpu_torch.ops import band, dense, dispatch
from torch_sharded_worker import profile_spans

PUBLISHED = {
    'sample_rate': 22050, 'hop_length': 512, 'fmin': pyin.FMIN,
    'fmax': pyin.FMAX, 'resolution': 0.1, 'max_transition_rate': 35.92,
    'switch_prob': 0.01}
# C3-C5 in half semitones: 49 pitch bins, a window of 21
SMALL = dict(PUBLISHED, fmin=440.0 * 2 ** ((48 - 69) / 12),
             fmax=440.0 * 2 ** ((72 - 69) / 12), resolution=0.5)
BINS, WIDTH = 49, 21
SMALL_MIX = {
    'voicing': {
        'voiced': {'median': 6, 'sigma': 0.6, 'low': 2, 'high': 20},
        'unvoiced': {'median': 3, 'sigma': 1.0, 'low': 1, 'high': 20}},
    'frames': {'step': 3, 'peak': [0.5, 0.9], 'octave_chance': 0.2,
               'octave_mass': [0.05, 0.2], 'octave_bins': 24,
               'stray_chance': 0.5, 'stray_mass': [0.0, 0.2]}}
LENGTHS = [60, 5, 33, 47, 12, 60, 21, 8]


def small_hmm():
    return (pyin.transition_matrix(pitch_bins=BINS, width=WIDTH),
            pyin.initial(pitch_bins=BINS))


def port_paths(observation, lengths, transition, initial):
    """The port's paths of probabilities, each cut to its length"""
    decoded = torbi_tpu_torch.from_probabilities(
        observation, torch.tensor(lengths, dtype=torch.int32), transition,
        initial, log_probs=False, gpu='cpu')
    return [decoded[row, :length].to(torch.int64)
            for row, length in enumerate(lengths)]


def log_inputs(observation, transition, initial):
    """The inputs as the configuration's guarantees convert them"""
    return (reference.log_observation(torch.as_tensor(observation)),
            *reference.log_hmm(torch.as_tensor(transition),
                               torch.as_tensor(initial)))


def reference_paths(observation, lengths, transition, initial):
    """The benchmark's plain reference decode and torbi_tpu's oracle on
    the converted inputs: both lists of paths, each cut to its length"""
    obs, trans, init = log_inputs(observation, transition, initial)
    plain = reference_viterbi.decode_blocks(
        [obs[row] for row in range(len(lengths))], lengths, trans, init)
    oracle = viterbi_numpy(obs.numpy(), np.array(lengths), trans.numpy(),
                           init.numpy())
    return plain, [torch.from_numpy(oracle[row, :length]).to(torch.int64)
                   for row, length in enumerate(lengths)]


def assert_paths_equal(got, want):
    assert len(got) == len(want)
    for row, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f'row {row}: {a.tolist()} != {b.tolist()}'


def librosa_local(bins, width):
    """librosa.sequence.transition_local(bins, width, window='triangle',
    wrap=False) as librosa writes it, with scipy's window: float64, row =
    source"""
    window = np.zeros(bins)
    start = (bins - width) // 2
    window[start:start + width] = windows.triang(width)
    local = np.zeros((bins, bins))
    for i in range(bins):
        row = np.roll(window, bins // 2 + i + 1)
        row[min(bins, i + width // 2 + 1):] = 0
        row[:max(0, i - width // 2)] = 0
        local[i] = row
    return local / local.sum(axis=1, keepdims=True)


def test_published_constants():
    assert (pyin.PITCH_BINS, pyin.TRANSITION_WIDTH, pyin.STATES) == (
        601, 101, 1202)
    assert pyin.FMIN == pytest.approx(65.406, abs=1e-3)
    assert pyin.FMAX == pytest.approx(2093.005, abs=1e-3)
    assert pyin.frames_to_seconds(861) == pytest.approx(19.99, abs=0.01)
    assert pyin.seconds_to_frames(20.0) == 861
    assert reference.sizes(PUBLISHED) == (601, 101)
    assert reference.sizes(SMALL) == (BINS, WIDTH)


def test_published_hmm_equals_the_benchmark_reference():
    transition = pyin.transition_matrix()
    initial = pyin.initial()
    want_transition, want_initial = reference.hmm(PUBLISHED)
    assert transition.shape == (1202, 1202)
    assert transition.dtype == np.float32
    assert np.array_equal(transition, want_transition.numpy())
    assert np.array_equal(initial, want_initial.numpy())
    # Row = destination: librosa's rows, the sources, are its columns
    assert np.allclose(transition.sum(axis=0), 1, atol=2e-6)
    assert int((transition > 0).sum()) == 232604
    assert float(np.abs(transition - transition.T).max()) > 0.0088
    assert float(initial[:601].sum()) == 0
    assert np.all(initial[601:] == np.float32(1 / 601))
    # The voiced-unvoiced blocks lie 601 states off the diagonal: no band
    with np.errstate(divide='ignore'):
        log_transition = np.log(transition)
    assert band.detect_band(log_transition) is None


@pytest.mark.parametrize('bins, width', [(601, 101), (49, 21), (50, 11)])
def test_transition_local_is_librosas(bins, width):
    assert np.array_equal(pyin.transition_local(bins, width),
                          librosa_local(bins, width))
    assert np.array_equal(reference.transition_local(bins, width),
                          librosa_local(bins, width))


def test_observation_and_state_helpers():
    voiced = np.zeros((2, 3, BINS), np.float32)
    voiced[0, 0, 4] = 0.75
    voiced[0, 1, [4, 28]] = [0.9, 0.2]     # clipped to a voiced 1
    probabilities = pyin.observation(voiced)
    assert probabilities.shape == (2, 3, 2 * BINS)
    assert np.allclose(probabilities[0, 0, BINS:], 0.25 / BINS)
    assert not np.any(probabilities[0, 1, BINS:])
    assert np.allclose(probabilities[1, :, BINS:], 1 / BINS)
    assert np.array_equal(
        pyin.observation(torch.from_numpy(voiced)).numpy(), probabilities)
    frequency, voiced_flag = pyin.states(torch.tensor([0, 120, 601, 1201]))
    assert voiced_flag.tolist() == [True, True, False, False]
    assert frequency[0] == frequency[2] == pytest.approx(pyin.FMIN)
    assert frequency[1] == pytest.approx(2 * pyin.FMIN)
    assert frequency[3] == pytest.approx(pyin.FMAX)


@pytest.mark.parametrize('seed', [0, 1, 2 ** 33 + 5])
def test_small_paths_equal_the_references(seed):
    transition, initial = small_hmm()
    observation = pyin_inputs.observations(
        LENGTHS, BINS, SMALL_MIX, inputs.device_generator(seed, 'cpu'),
        'cpu')
    got = port_paths(observation, LENGTHS, transition, initial)
    plain, oracle = reference_paths(observation, LENGTHS, transition,
                                    initial)
    assert_paths_equal(got, plain)
    assert_paths_equal(got, oracle)


def flipped_paths(observation, lengths, transition, initial):
    """The port's paths with the states in reverse order, mapped back: on
    a tie the highest of the original states wins"""
    states = transition.shape[0]
    reverse = list(range(states - 1, -1, -1))
    paths = port_paths(observation[..., reverse], lengths,
                       np.ascontiguousarray(transition[reverse][:, reverse]),
                       initial[reverse])
    return [states - 1 - path for path in paths]


def test_ties_go_to_the_first_source():
    """Unvoiced frames hold 49 equal values and voiced frames equal peaks
    on two bins, so equal candidates decide the path"""
    transition, initial = small_hmm()
    observation, lengths = tie_observation()
    got = port_paths(observation, lengths, transition, initial)
    # The other tie rule gives other paths: the ties decide them
    assert any(not torch.equal(a, b) for a, b in zip(
        got, flipped_paths(observation, lengths, transition, initial)))
    plain, oracle = reference_paths(observation, lengths, transition,
                                    initial)
    assert_paths_equal(got, plain)
    assert_paths_equal(got, oracle)


def test_minus_inf_transition_and_initial_entries():
    transition, initial = small_hmm()
    observation = pyin_inputs.observations(
        LENGTHS[:3], BINS, SMALL_MIX, inputs.device_generator(7, 'cpu'),
        'cpu')
    obs, trans, init = log_inputs(observation, transition, initial)
    assert torch.isinf(trans).sum() == 98 * 98 - int((transition > 0).sum())
    assert torch.all(torch.isneginf(init[:BINS]))
    post_seq, _ = dense.dense_forward_reference(
        obs, torch.tensor(LENGTHS[:3], dtype=torch.int32), trans, init)
    # Frame 0 holds -inf on every voiced state, none after it
    assert torch.all(torch.isneginf(post_seq[:, 0, :BINS]))
    assert torch.all(torch.isfinite(post_seq[:, 1:]))
    got = port_paths(observation, LENGTHS[:3], transition, initial)
    assert all(int(path[0]) >= BINS for path in got)
    assert_paths_equal(got, reference_paths(
        observation, LENGTHS[:3], transition, initial)[1])


def test_the_orientation_changes_the_path():
    """Mass on bins 46 and 48 at the top edge, then 47: near the edge the
    rows are normalised over fewer bins, so the transposed matrix moves
    the path"""
    transition, initial = small_hmm()
    voiced = np.zeros((1, 3, BINS), np.float32)
    voiced[0, 1, 46], voiced[0, 1, 48], voiced[0, 2, 47] = 0.4, 0.3, 0.9
    observation = pyin.observation(voiced)
    got = port_paths(observation, [3], transition, initial)
    transposed = np.ascontiguousarray(transition.T)
    wrong = port_paths(observation, [3], transposed, initial)
    assert got[0].tolist() == [97, 48, 47]
    assert wrong[0].tolist() == [95, 46, 47]
    assert_paths_equal(got, reference_paths(
        observation, [3], transition, initial)[0])
    assert_paths_equal(wrong, reference_paths(
        observation, [3], transposed, initial)[0])


def tie_observation():
    """Unvoiced frames of 49 equal values beside voiced frames with equal
    peaks on two bins; the rows' lengths"""
    voiced = np.zeros((3, 24, BINS), np.float32)
    voiced[1, 8:16, [20, 30]] = 0.4
    voiced[2, ::2, 10] = 0.5
    voiced[2, 1::2, 12] = 0.5
    return pyin.observation(voiced), [24, 20, 23]


@pytest.mark.parametrize('backend', [None, 'scan'])
@pytest.mark.parametrize('case', ['generated', 'ties'])
def test_probabilities_equal_torbi_tpus(case, backend):
    """The same probabilities, transition and initial distribution given
    to both packages' from_probabilities(..., log_probs=False): the port's
    own conversion on the dense route (and on the scan backend) gives
    bitwise the JAX package's paths"""
    transition, initial = small_hmm()
    if case == 'generated':
        observation = pyin_inputs.observations(
            LENGTHS, BINS, SMALL_MIX, inputs.device_generator(11, 'cpu'),
            'cpu').numpy()
        lengths = LENGTHS
    else:
        observation, lengths = tie_observation()
    got = torbi_tpu_torch.from_probabilities(
        observation, torch.tensor(lengths, dtype=torch.int32), transition,
        initial, log_probs=False, gpu='cpu', backend=backend)
    want = np.asarray(torbi_tpu.from_probabilities(
        observation, np.array(lengths, np.int32), transition, initial,
        log_probs=False))
    for row, length in enumerate(lengths):
        assert np.array_equal(got[row, :length].numpy(),
                              want[row, :length]), f'row {row}'


def counts():
    return (dispatch.convert.values, dict(dispatch.decode.dense_reasons))


def profiled_spans(run):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        run()
    return [pair for pair in profile_spans(profile)
            if pair[0] != 'torbi.build']


def test_one_dense_decode_converts_and_counts_once():
    transition, initial = small_hmm()
    observation = pyin_inputs.observations(
        LENGTHS, BINS, SMALL_MIX, inputs.device_generator(3, 'cpu'), 'cpu')
    values, reasons = counts()
    found = profiled_spans(lambda: port_paths(
        observation, LENGTHS, transition, initial))
    assert found == [
        ('torbi.from_probabilities', None),
        ('torbi.decode', 'torbi.from_probabilities'),
        ('torbi.convert', 'torbi.decode'),
        ('torbi.forward.dense_forward', 'torbi.decode'),
        ('torbi.chase.backtrace', 'torbi.decode')]
    after_values, after_reasons = counts()
    assert after_values - values == observation.numel() == 8 * 60 * 98
    assert after_reasons == dict(reasons, width=reasons['width'] + 1)


def banded(states=64, halfwidth=3):
    """A banded log transition over a -inf exterior and a log observation
    of 3 rows"""
    rng = np.random.default_rng(5)
    bins = np.arange(states)
    trans = np.where(np.abs(bins[:, None] - bins[None, :]) <= halfwidth,
                     rng.uniform(0.1, 1, (states, states)), 0.0)
    trans = (trans / trans.sum(axis=1, keepdims=True)).astype(np.float32)
    obs = rng.dirichlet(np.ones(states), size=(3, 20)).astype(np.float32)
    return obs, trans


@pytest.mark.parametrize('batch, forward', [
    (3, 'band_forward'), (1, 'band_spread')])
def test_banded_routes_neither_convert_nor_count(batch, forward):
    obs, trans = banded()
    values, reasons = counts()
    found = profiled_spans(lambda: torbi_tpu_torch.from_probabilities(
        obs[:batch], None, trans, log_probs=False, gpu='cpu'))
    names = [name for name, _ in found]
    assert f'torbi.forward.{forward}' in names
    assert 'torbi.convert' not in names
    assert counts() == (values, reasons)


@pytest.mark.parametrize('reason', ['floor', 'observation', 'backend'])
def test_each_reason_for_the_dense_route(monkeypatch, reason):
    """A banded transition sent to K2: with pYIN's kind of initial
    distribution (zeros, so -inf, beside a -inf exterior), with a -inf
    in a log observation decoded without the epsilon step (nothing to
    convert), or with the banded kernels switched off"""
    obs, trans = banded()
    initial = np.full(64, 1 / 64, np.float32)
    if reason == 'floor':
        initial[:32] = 0
        initial[32:] = 1 / 32
    elif reason == 'backend':
        monkeypatch.setattr(torbi_tpu_torch, 'USE_BAND_KERNEL', False)
    with np.errstate(divide='ignore'):
        log_trans, log_initial = np.log(trans), np.log(initial)
        log_obs = np.log(np.exp(np.log(obs)) + np.finfo(np.float32).tiny)
    if reason == 'observation':
        log_obs[1, 4, 7] = -np.inf

        def decode():
            return dispatch.decode(
                log_obs, np.full(3, 20, np.int32), log_trans, log_initial,
                device='cpu')
    else:
        def decode():
            return torbi_tpu_torch.from_probabilities(
                obs, None, trans, initial, log_probs=False, gpu='cpu')
    values, reasons = counts()
    found = profiled_spans(decode)
    assert [name for name, _ in found].count(
        'torbi.forward.dense_forward') == 1
    after_values, after_reasons = counts()
    assert after_values - values == (0 if reason == 'observation'
                                     else obs.size)
    assert after_reasons == dict(reasons, **{reason: reasons[reason] + 1})
    # The dense route's path is the oracle's
    want = viterbi_numpy(log_obs.astype(np.float32), np.full(3, 20),
                         log_trans, log_initial)
    assert np.array_equal(decode().numpy(), want)
