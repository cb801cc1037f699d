"""The least time a decode's work needs on an H100, counted from its
inputs' shapes.

The peaks are NVIDIA's published H100 SXM figures (its data sheet, dense
rates): 67 TFLOP/s in float32 outside the tensor cores, and 3.35 TB/s of
HBM3 bandwidth. The 67 TFLOP/s count a fused multiply-add as two
operations: 132 SMs of 128 float32 lanes at 1.98 GHz, one instruction a
lane a clock, so 33.5e12 float32 instructions a second. The decode has no
multiply-add to fuse: an operation here is one instruction (an add or a
max), held against that rate, so a share of this roofline can reach 100%
and no more. The peaks assume the card's full power limit of 700 W, so a
share is printed beside the card's limit.

The work is the algorithm's, not a kernel's: a candidate is a (source,
destination) pair whose transition probability is above zero, and it
costs an add and a max; where some pair has probability zero, the floor
that stands in for all of them costs one max over the sources a frame
(``states`` candidates). Every frame after a row's first visits every
candidate. The bytes are the observation read once, the candidates'
transition values read once a call, and the indices written once, 4
bytes each. The padding of a batch is no work.
"""
FP32_FLOPS = 67e12
# An add or a max a lane a clock: the published rate counts an FMA as two
FP32_INSTRUCTIONS_PER_S = FP32_FLOPS / 2
HBM_BYTES_PER_S = 3.35e12
OPERATIONS_PER_CANDIDATE = 2
BYTES_PER_VALUE = 4


def candidates_per_frame(probabilities):
    """(in-band pairs, floor candidates) of one frame of one row, from the
    (states, states) transition probabilities (a tensor or array)"""
    positive = probabilities > 0
    pairs = int(positive.sum())
    states = int(probabilities.shape[0])
    return pairs, (0 if pairs == states * states else states)


def decode_work(row_lengths, states, pairs, floor):
    """(operations, bytes) of one decode call over rows of
    ``row_lengths`` real frames"""
    frames = sum(row_lengths)
    steps = sum(max(length - 1, 0) for length in row_lengths)
    operations = OPERATIONS_PER_CANDIDATE * steps * (pairs + floor)
    moved = BYTES_PER_VALUE * (frames * states + pairs + frames)
    return operations, moved


def least_seconds(operations, moved):
    """The larger of the operations bound and the bytes bound"""
    return max(operations / FP32_INSTRUCTIONS_PER_S,
               moved / HBM_BYTES_PER_S)
