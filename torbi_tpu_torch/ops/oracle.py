"""Pure-numpy reference oracle.

The port's own copy of ``torbi_tpu/ops/oracle.py``; it decodes the same
way twice over:

- ``viterbi_numpy``: a literal, loop-based float32 max-sum recursion with
  the decoders' contract (lowest-index tie-breaking, masked frames,
  broadcast argmax seed). The soak (``scripts/soak.py``) holds every route
  against it.
- ``viterbi_librosa_style``: probability-space float64 decoding following
  the algorithm of ``librosa.sequence.viterbi`` (log space internally),
  the ground truth of the evaluation harness (``reference/core.py``),
  used when librosa is not installed.
"""
import numpy as np


def viterbi_numpy(observation, batch_frames, transition, initial):
    """Loop-based float32 oracle matching the reference CPU kernel contract.

    observation: (N, T, S) float32 log-probs
    batch_frames: (N,) int
    transition: (S, S) float32 log-probs (row = destination)
    initial: (S,) float32 log-probs
    returns (N, T) int32
    """
    observation = np.asarray(observation, dtype=np.float32)
    transition = np.asarray(transition, dtype=np.float32)
    initial = np.asarray(initial, dtype=np.float32)
    batch_frames = np.asarray(batch_frames, dtype=np.int64)
    N, T, S = observation.shape
    indices = np.zeros((N, T), dtype=np.int32)
    for b in range(N):
        frames = int(batch_frames[b])
        trellis = np.zeros((T, S), dtype=np.int32)
        post = observation[b, 0] + initial
        for t in range(1, frames):
            scores = post[None, :] + transition  # (S_dest, S_src)
            # first maximum wins (lowest source index)
            arg = np.argmax(scores, axis=1)
            best = scores[np.arange(S), arg]
            trellis[t] = arg
            post = observation[b, t] + best
        seed = int(np.argmax(post))
        indices[b, :] = seed
        index = seed
        for t in range(frames - 1, 0, -1):
            index = int(trellis[t, index])
            indices[b, t - 1] = index
    return indices


def viterbi_librosa_style(observation_probs, transition_probs, initial_probs):
    """Single-sequence float64 probability-space Viterbi (librosa semantics).

    observation_probs: (T, S) probabilities (not log)
    transition_probs: (S, S) probabilities, rows sum to 1 (row = source in
        librosa convention: prob[i, j] = P(j at t+1 | i at t))
    initial_probs: (S,)
    returns (T,) int64

    Band-limited transitions (every column's nonzero support contiguous,
    e.g. the pitch matrix) take an O(S*W)-per-frame path that is BITWISE
    identical to the dense recursion (``_viterbi_librosa_dense``) -- at
    the evaluation's scale (8,192 stems x 2 corpora) the dense float64
    loop alone would cost many hours of CPU time.
    """
    observation = np.asarray(observation_probs, dtype=np.float64)
    initial = np.asarray(initial_probs, dtype=np.float64)
    transition, band, tables = _transition_analysis(transition_probs)
    if band is not None and (band[1] - band[0]).max() + 1 <= (
            transition.shape[0] + 1) // 2:
        return _viterbi_librosa_banded(
            observation, transition, initial, band, tables)
    return _viterbi_librosa_dense(observation, transition, initial)


# Single-slot cache of the per-transition analysis (band detection +
# banded gather tables): the evaluation harness decodes thousands of files
# against ONE transition matrix object, and rebuilding the tables costs
# more than decoding a short file. The cache holds a strong reference to
# the key object, so the identity check cannot alias a recycled id.
_transition_cache = None


def _transition_analysis(transition_probs):
    """(float64 transition, band, banded gather tables) with caching"""
    global _transition_cache
    if _transition_cache is not None:
        cached_obj, result = _transition_cache
        if cached_obj is transition_probs:
            return result
    transition = np.asarray(transition_probs, dtype=np.float64)
    band = _column_band(transition)
    tables = None
    if band is not None and (band[1] - band[0]).max() + 1 <= (
            transition.shape[0] + 1) // 2:
        tables = _banded_tables(transition, band)
    result = (transition, band, tables)
    _transition_cache = (transition_probs, result)
    return result


def _viterbi_librosa_dense(observation, transition, initial):
    """The literal dense recursion (the bitwise contract both paths meet)"""
    T, S = observation.shape
    eps = np.finfo(np.float64).tiny
    log_obs = np.log(observation + eps)
    log_trans = np.log(transition + eps)
    log_init = np.log(initial + eps)

    value = np.zeros((T, S), dtype=np.float64)
    ptr = np.zeros((T, S), dtype=np.int64)
    value[0] = log_obs[0] + log_init
    for t in range(1, T):
        # librosa: trans_out[i, j] = value[t-1, i] + log_trans[i, j]
        trans_out = value[t - 1][:, None] + log_trans
        ptr[t] = np.argmax(trans_out, axis=0)
        value[t] = log_obs[t] + np.max(trans_out, axis=0)

    path = np.zeros(T, dtype=np.int64)
    path[-1] = np.argmax(value[-1])
    for t in range(T - 2, -1, -1):
        path[t] = ptr[t + 1, path[t + 1]]
    return path


def _column_band(transition):
    """Per-destination-column contiguous nonzero support of a probability-
    space transition: (first, last) index arrays, or None when any column's
    support is empty or non-contiguous (dense decoding applies)."""
    nonzero = transition > 0
    if not nonzero.any(axis=0).all():
        return None
    first = nonzero.argmax(axis=0)
    last = transition.shape[0] - 1 - nonzero[::-1].argmax(axis=0)
    if not (nonzero.sum(axis=0) == last - first + 1).all():
        return None
    return first, last


def _running_first_argmax(values):
    """(running max, index of its FIRST occurrence) along a 1-D array --
    the prefix decomposition of np.argmax's lowest-index tie rule"""
    running = np.maximum.accumulate(values)
    previous = np.concatenate(([-np.inf], running[:-1]))
    # The argmax resets only on a STRICT increase; later equal values keep
    # the earlier index, exactly like np.argmax
    reset = np.where(values > previous, np.arange(values.shape[0]), 0)
    return running, np.maximum.accumulate(reset)


def _suffix_first_argmax(values):
    """(suffix max over [i:], LOWEST index in [i:] achieving it) -- the
    suffix decomposition of the same lowest-index tie rule"""
    size = values.shape[0]
    reversed_values = values[::-1]
    running = np.maximum.accumulate(reversed_values)
    previous = np.concatenate(([-np.inf], running[:-1]))
    # Non-strict resets: a later reversed position with an EQUAL value is
    # a lower ORIGINAL index and must take over
    reset = np.where(reversed_values >= previous, np.arange(size), 0)
    arg = size - 1 - np.maximum.accumulate(reset)
    return running[::-1], arg[::-1]


def _banded_tables(transition, band):
    """Precomputed window-gather tables for ``_viterbi_librosa_banded``.

    Column j's candidate window is the CONTIGUOUS source range
    [start_j, start_j + W) with start_j = min(first_j, S - W): always
    inside [0, S), always covering the column's band [first_j, last_j]
    (the band is at most W wide). Window entries outside the band have
    transition probability 0, so their gathered addend is exactly
    log(0 + eps) = the out-of-band addend -- the recursion's prefix/suffix
    scans already model those candidates, and the merge rule keeps the
    result identical (see ``_viterbi_librosa_banded``). Rebuilding these
    tables costs ~30 ms; cached per transition (``_transition_analysis``)
    that overhead amortizes to nothing over an evaluation corpus.
    """
    S = transition.shape[0]
    eps = np.finfo(np.float64).tiny
    first, last = band
    width = int((last - first).max()) + 1
    start = np.minimum(first, S - width)
    offsets = start[:, None] + np.arange(width)[None, :]
    with np.errstate(divide='ignore'):
        gathered_trans = np.log(
            transition[offsets, np.arange(S)[:, None]] + eps)
    return start, offsets, gathered_trans


def _viterbi_librosa_banded(observation, transition, initial, band,
                            tables=None):
    """O(S*W)-per-frame recursion, bitwise equal to the dense one.

    For destination j the dense argmax scans candidates
    fl(value[i] + log_trans[i, j]) over all sources i. The contiguous
    window [start_j, start_j + W) covers the column's in-band sources
    (trans[i, j] > 0) and is gathered and reduced directly -- the
    identical float64 adds in the identical index order. Every
    out-of-band source contributes the SAME addend log(0 + eps), and
    float addition of a constant is monotone, so the out-of-band maximum
    is fl(max value + log_eps)... but NOT its argmax: two distinct values
    may round to one sum, and np.argmax takes the lowest index of the
    SUM. Both reductions therefore run over the summed array
    s[i] = fl(value[i] + log_eps) with first-occurrence prefix/suffix
    scans, preserving the tie rule exactly.

    Out-of-band sources that fall INSIDE the window (edge-clipped
    columns) are covered twice: their window candidate is the same
    bitwise value fl(value[i] + log_eps) as the scans', the window argmax
    picks the lowest window index on ties (window order == index order),
    and the scans' first occurrence over the SUPERSET of out-of-band
    sources has index <= any window duplicate -- so the lowest-index
    merge below resolves every tie exactly as the dense argmax does.
    """
    T, S = observation.shape
    eps = np.finfo(np.float64).tiny
    log_obs = np.log(observation + eps)
    log_init = np.log(initial + eps)
    log_eps = np.log(eps)  # == np.log(0.0 + eps): the out-of-band addend

    first, last = band
    if tables is None:
        tables = _banded_tables(transition, band)
    start, offsets, gathered_trans = tables
    cols = np.arange(S)

    value = np.zeros((T, S), dtype=np.float64)
    ptr = np.zeros((T, S), dtype=np.int64)
    value[0] = log_obs[0] + log_init
    for t in range(1, T):
        prev = value[t - 1]

        # Windowed candidates: the identical float64 adds in index order
        cand = prev[offsets] + gathered_trans     # (S, W)
        in_k = np.argmax(cand, axis=1)
        in_val = cand[cols, in_k]
        in_idx = start + in_k

        # Out-of-band: first-occurrence prefix/suffix maxima of the summed
        # candidates, -inf-padded for empty regions
        summed = prev + log_eps
        pre_max, pre_arg = _running_first_argmax(summed)
        pre_max = np.concatenate(([-np.inf], pre_max))
        pre_arg = np.concatenate(([0], pre_arg))
        suf_max, suf_arg = _suffix_first_argmax(summed)
        suf_max = np.concatenate((suf_max, [-np.inf]))
        suf_arg = np.concatenate((suf_arg, [0]))

        pre_v, pre_i = pre_max[first], pre_arg[first]
        suf_v, suf_i = suf_max[last + 1], suf_arg[last + 1]
        # Prefix indices precede suffix indices, so prefix wins exact ties
        out_v = np.where(pre_v >= suf_v, pre_v, suf_v)
        out_i = np.where(pre_v >= suf_v, pre_i, suf_i)

        # Lowest overall index on exact in/out ties (disjoint index sets)
        take_out = (out_v > in_val) | ((out_v == in_val) & (out_i < in_idx))
        ptr[t] = np.where(take_out, out_i, in_idx)
        value[t] = log_obs[t] + np.where(take_out, out_v, in_val)

    path = np.zeros(T, dtype=np.int64)
    path[-1] = np.argmax(value[-1])
    for t in range(T - 2, -1, -1):
        path[t] = ptr[t + 1, path[t + 1]]
    return path
