"""Bit-exact reimplementation of the WebRTC GMM voice-activity detector.

A copy of `pocketsphinx_tpu.vad.webrtc` (host integer code).

This is the behavior contract behind the reference's ``ps_vad_t``
(``src/ps_vad.c`` wraps ``src/common_audio/vad``): a 6-band fixed-point
energy front end feeding per-band two-component noise/speech GMMs with
adaptive model updates and hangover smoothing.  The ``live`` CLI mode's
golden outputs depend on the exact integer arithmetic, so this module
reproduces it operation-for-operation in Python integers (two's
complement int16/int32 semantics emulated explicitly).

Reference files (studied, not copied — this is a from-scratch Python
expression of the same published WebRTC algorithm):
  - src/common_audio/vad/vad_core.c        (GmmProbability, mode tables)
  - src/common_audio/vad/vad_filterbank.c  (split filters, log energy)
  - src/common_audio/vad/vad_gmm.c         (GaussianProbability)
  - src/common_audio/vad/vad_sp.c          (Downsampling, FindMinimum)
  - src/common_audio/signal_processing/    (energy, norm, division,
      resample_48khz + resample_by_2_internal + resample_fractional)

All state lives in :class:`VadCore`; frames are 10/20/30 ms of int16 PCM
at 8/16/32/48 kHz, exactly as ``WebRtcVad_Process`` accepts.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Two's-complement helpers (C int16_t / int32_t semantics)
# ---------------------------------------------------------------------------


def _s16(x: int) -> int:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _s32(x: int) -> int:
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _cdiv(num: int, den: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(num) // abs(den)
    return -q if (num < 0) != (den < 0) else q


def _div_w32_w16(num: int, den: int) -> int:
    """WebRtcSpl_DivW32W16 (division_operations.c)."""
    if den != 0:
        return _s32(_cdiv(num, den))
    return 0x7FFFFFFF


def _clz32(n: int) -> int:
    n &= 0xFFFFFFFF
    if n == 0:
        return 32
    return 32 - n.bit_length()


def _norm_w32(a: int) -> int:
    """WebRtcSpl_NormW32: left-shift headroom of an int32."""
    if a == 0:
        return 0
    return _clz32(~a & 0xFFFFFFFF if a < 0 else a) - 1


def _norm_u32(a: int) -> int:
    return 0 if a == 0 else _clz32(a)


def _get_size_in_bits(n: int) -> int:
    return 32 - _clz32(n)


# ---------------------------------------------------------------------------
# Energy (signal_processing/energy.c + get_scaling_square.c)
# ---------------------------------------------------------------------------


def _energy(vec: list[int]) -> tuple[int, int]:
    """Returns (energy, scale_factor) like WebRtcSpl_Energy."""
    nbits = _get_size_in_bits(len(vec))
    smax = -1
    for v in vec:
        sabs = _s16(v if v > 0 else -v)
        if sabs > smax:
            smax = sabs
    if smax == 0:
        scaling = 0
    else:
        t = _norm_w32(_s32(smax * smax))
        scaling = 0 if t > nbits else nbits - t
    en = 0
    for v in vec:
        en = _s32(en + ((v * v) >> scaling))
    return en, scaling


# ---------------------------------------------------------------------------
# Filterbank (vad_filterbank.c)
# ---------------------------------------------------------------------------

_LOG_CONST = 24660          # 160*log10(2) in Q9
_LOG_ENERGY_INT_PART = 14336  # 14 in Q10
_HP_ZERO = (6631, -13262, 6631)   # Q14
_HP_POLE = (16384, -7756, 5620)   # Q14
_ALLPASS_Q15 = (20972, 5571)      # upper 0.64 / lower 0.17
_OFFSET_VECTOR = (368, 368, 272, 176, 176, 176)
_MIN_ENERGY = 10


def _high_pass_filter(data_in, state):
    out = []
    for x in data_in:
        tmp32 = _HP_ZERO[0] * x + _HP_ZERO[1] * state[0] + _HP_ZERO[2] * state[1]
        state[1] = state[0]
        state[0] = x
        tmp32 -= _HP_POLE[1] * state[2] + _HP_POLE[2] * state[3]
        state[3] = state[2]
        state[2] = _s16(_s32(tmp32) >> 14)
        out.append(state[2])
    return out


def _all_pass_filter(data_in, coefficient, state_box, si):
    """vad_filterbank.c AllPassFilter over every 2nd input sample."""
    out = []
    state32 = _s32(state_box[si] * (1 << 16))
    for x in data_in:
        tmp32 = _s32(state32 + coefficient * x)
        tmp16 = _s16(tmp32 >> 16)
        out.append(tmp16)
        state32 = _s32((x * (1 << 14)) - coefficient * tmp16)
        state32 = _s32(state32 * 2)
    state_box[si] = _s16(state32 >> 16)
    return out


def _split_filter(data_in, upper_state, lower_state, band):
    half = len(data_in) >> 1
    hp = _all_pass_filter(data_in[0::2][:half], _ALLPASS_Q15[0], upper_state, band)
    lp = _all_pass_filter(data_in[1::2][:half], _ALLPASS_Q15[1], lower_state, band)
    hp_out, lp_out = [], []
    for h, l in zip(hp, lp):
        hp_out.append(_s16(h - l))
        lp_out.append(_s16(l + h))
    return hp_out, lp_out


def _log_of_energy(data_in, offset, total_energy):
    """Returns (log_energy, new_total_energy)."""
    energy, tot_rshifts = _energy(data_in)
    energy &= 0xFFFFFFFF  # viewed as uint32
    if energy == 0:
        return offset, total_energy
    normalizing_rshifts = 17 - _norm_u32(energy)
    log2_energy = _LOG_ENERGY_INT_PART
    tot_rshifts += normalizing_rshifts
    if normalizing_rshifts < 0:
        energy = (energy << -normalizing_rshifts) & 0xFFFFFFFF
    else:
        energy >>= normalizing_rshifts
    log2_energy += (energy & 0x00003FFF) >> 4
    log_energy = _s16(((_LOG_CONST * log2_energy) >> 19)
                      + ((tot_rshifts * _LOG_CONST) >> 9))
    if log_energy < 0:
        log_energy = 0
    log_energy = _s16(log_energy + offset)
    if total_energy <= _MIN_ENERGY:
        if tot_rshifts >= 0:
            total_energy = _s16(total_energy + _MIN_ENERGY + 1)
        else:
            total_energy = _s16(total_energy + (energy >> -tot_rshifts))
    return log_energy, total_energy


def _calculate_features(self, data_in):
    """WebRtcVad_CalculateFeatures: 6 band log-energies + total energy."""
    features = [0] * 6
    total_energy = 0
    # Split at 2000 Hz.
    hp_120, lp_120 = _split_filter(data_in, self.upper_state, self.lower_state, 0)
    # Upper band: split at 3000 Hz.
    hp_60, lp_60 = _split_filter(hp_120, self.upper_state, self.lower_state, 1)
    features[5], total_energy = _log_of_energy(hp_60, _OFFSET_VECTOR[5], total_energy)
    features[4], total_energy = _log_of_energy(lp_60, _OFFSET_VECTOR[4], total_energy)
    # Lower band: split at 1000 Hz.
    hp_60, lp_60 = _split_filter(lp_120, self.upper_state, self.lower_state, 2)
    features[3], total_energy = _log_of_energy(hp_60, _OFFSET_VECTOR[3], total_energy)
    # Split at 500 Hz.
    hp_120b, lp_120b = _split_filter(lp_60, self.upper_state, self.lower_state, 3)
    features[2], total_energy = _log_of_energy(hp_120b, _OFFSET_VECTOR[2], total_energy)
    # Split at 250 Hz.
    hp_60b, lp_60b = _split_filter(lp_120b, self.upper_state, self.lower_state, 4)
    features[1], total_energy = _log_of_energy(hp_60b, _OFFSET_VECTOR[1], total_energy)
    # Remove 0-80 Hz from the remaining low band.
    hp = _high_pass_filter(lp_60b, self.hp_filter_state)
    features[0], total_energy = _log_of_energy(hp, _OFFSET_VECTOR[0], total_energy)
    return total_energy, features


# ---------------------------------------------------------------------------
# Gaussian probability (vad_gmm.c)
# ---------------------------------------------------------------------------

_COMP_VAR = 22005
_LOG2_EXP = 5909  # log2(e) in Q12


def _gaussian_probability(inp, mean, std):
    """Returns (probability Q20, delta Q11)."""
    tmp32 = 131072 + (std >> 1)
    inv_std = _s16(_div_w32_w16(tmp32, std))
    tmp16 = inv_std >> 2
    inv_std2 = _s16((tmp16 * tmp16) >> 2)
    tmp16 = _s16(inp << 3)
    tmp16 = _s16(tmp16 - mean)
    delta = _s16((inv_std2 * tmp16) >> 10)
    tmp32 = (delta * tmp16) >> 9
    exp_value = 0
    if tmp32 < _COMP_VAR:
        t = _s16((_LOG2_EXP * tmp32) >> 12)
        t = _s16(-t)
        exp_value = 0x0400 | (t & 0x03FF)
        t = _s16(t ^ 0xFFFF)
        t >>= 10
        t += 1
        exp_value >>= t
    return _s32(inv_std * exp_value), delta


# ---------------------------------------------------------------------------
# Minimum tracking (vad_sp.c FindMinimum)
# ---------------------------------------------------------------------------

_SMOOTHING_DOWN = 6553   # 0.2 in Q15
_SMOOTHING_UP = 32439    # 0.99 in Q15


def _find_minimum(self, feature_value, channel):
    offset = channel << 4
    age = self.index_vector
    smallest = self.low_value_vector
    # Age and expire.
    for i in range(16):
        if age[offset + i] != 100:
            age[offset + i] += 1
        else:
            for j in range(i, 15):
                smallest[offset + j] = smallest[offset + j + 1]
                age[offset + j] = age[offset + j + 1]
            age[offset + 15] = 101
            smallest[offset + 15] = 10000
    # Insertion position among the 16 smallest (binary cascade in C;
    # a linear scan gives the identical position).
    position = -1
    if feature_value < smallest[offset + 15]:
        position = 15
        while position > 0 and feature_value < smallest[offset + position - 1]:
            position -= 1
    if position > -1:
        for i in range(15, position, -1):
            smallest[offset + i] = smallest[offset + i - 1]
            age[offset + i] = age[offset + i - 1]
        smallest[offset + position] = feature_value
        age[offset + position] = 1
    current_median = 1600
    if self.frame_counter > 2:
        current_median = smallest[offset + 2]
    elif self.frame_counter > 0:
        current_median = smallest[offset + 0]
    alpha = 0
    if self.frame_counter > 0:
        alpha = _SMOOTHING_DOWN if current_median < self.mean_value[channel] \
            else _SMOOTHING_UP
    tmp32 = (alpha + 1) * self.mean_value[channel]
    tmp32 += (32767 - alpha) * current_median
    tmp32 += 16384
    self.mean_value[channel] = _s16(_s32(tmp32) >> 15)
    return self.mean_value[channel]


# ---------------------------------------------------------------------------
# GMM decision core (vad_core.c)
# ---------------------------------------------------------------------------

_NUM_CHANNELS = 6
_NUM_GAUSSIANS = 2
_TABLE_SIZE = _NUM_CHANNELS * _NUM_GAUSSIANS

_SPECTRUM_WEIGHT = (6, 8, 10, 12, 14, 16)
_NOISE_UPDATE_CONST = 655     # Q15
_SPEECH_UPDATE_CONST = 6554   # Q15
_BACK_ETA = 154               # Q8
_MINIMUM_DIFFERENCE = (544, 544, 576, 576, 576, 576)       # Q5
_MAXIMUM_SPEECH = (11392, 11392, 11520, 11520, 11520, 11520)  # Q7
_MINIMUM_MEAN = (640, 768)
_MAXIMUM_NOISE = (9216, 9088, 8960, 8832, 8704, 8576)      # Q7
_NOISE_DATA_WEIGHTS = (34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103)
_SPEECH_DATA_WEIGHTS = (48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81)
_NOISE_DATA_MEANS = (6738, 4892, 7065, 6715, 6771, 3369,
                     7646, 3863, 7820, 7266, 5020, 4362)
_SPEECH_DATA_MEANS = (8306, 10085, 10078, 11823, 11843, 6309,
                      9473, 9571, 10879, 7581, 8180, 7483)
_NOISE_DATA_STDS = (378, 1064, 493, 582, 688, 593,
                    474, 697, 475, 688, 421, 455)
_SPEECH_DATA_STDS = (555, 505, 567, 524, 585, 1231,
                     509, 828, 492, 1540, 1079, 850)
_MAX_SPEECH_FRAMES = 6
_MIN_STD = 384

# Aggressiveness mode tables: (overhang_max_1, overhang_max_2,
# local threshold, global threshold), each indexed by 10/20/30 ms.
_MODE_TABLES = {
    0: ((8, 4, 3), (14, 7, 5), (24, 21, 24), (57, 48, 57)),
    1: ((8, 4, 3), (14, 7, 5), (37, 32, 37), (100, 80, 100)),
    2: ((6, 3, 2), (9, 5, 3), (82, 78, 82), (285, 260, 285)),
    3: ((6, 3, 2), (9, 5, 3), (94, 94, 94), (1100, 1050, 1100)),
}


def _weighted_average(means, channel, offset, weights):
    weighted_average = 0
    for k in range(_NUM_GAUSSIANS):
        i = channel + k * _NUM_CHANNELS
        means[i] = _s16(means[i] + offset)
        weighted_average = _s32(weighted_average
                                + means[i] * weights[i])
    return weighted_average


def _gmm_probability(self, features, total_power, frame_length):
    vadflag = 0
    if frame_length == 80:
        fi = 0
    elif frame_length == 160:
        fi = 1
    else:
        fi = 2
    overhead1 = self.over_hang_max_1[fi]
    overhead2 = self.over_hang_max_2[fi]
    individual_test = self.individual[fi]
    total_test = self.total[fi]

    if total_power > _MIN_ENERGY:
        sum_llr = 0
        deltaN = [0] * _TABLE_SIZE
        deltaS = [0] * _TABLE_SIZE
        ngprvec = [0] * _TABLE_SIZE
        sgprvec = [0] * _TABLE_SIZE
        noise_prob = [0, 0]
        speech_prob = [0, 0]

        for channel in range(_NUM_CHANNELS):
            h0_test = 0
            h1_test = 0
            for k in range(_NUM_GAUSSIANS):
                gaussian = channel + k * _NUM_CHANNELS
                p, d = _gaussian_probability(features[channel],
                                             self.noise_means[gaussian],
                                             self.noise_stds[gaussian])
                deltaN[gaussian] = d
                noise_prob[k] = _NOISE_DATA_WEIGHTS[gaussian] * p
                h0_test = _s32(h0_test + noise_prob[k])
                p, d = _gaussian_probability(features[channel],
                                             self.speech_means[gaussian],
                                             self.speech_stds[gaussian])
                deltaS[gaussian] = d
                speech_prob[k] = _SPEECH_DATA_WEIGHTS[gaussian] * p
                h1_test = _s32(h1_test + speech_prob[k])

            shifts_h0 = 31 if h0_test == 0 else _norm_w32(h0_test)
            shifts_h1 = 31 if h1_test == 0 else _norm_w32(h1_test)
            llr = shifts_h0 - shifts_h1
            sum_llr += llr * _SPECTRUM_WEIGHT[channel]
            if (llr * 4) > individual_test:
                vadflag = 1

            h0 = _s16(h0_test >> 12)
            if h0 > 0:
                tmp1_s32 = _s32((noise_prob[0] & 0xFFFFF000) << 2)
                ngprvec[channel] = _s16(_div_w32_w16(tmp1_s32, h0))
                ngprvec[channel + _NUM_CHANNELS] = 16384 - ngprvec[channel]
            else:
                ngprvec[channel] = 16384
            h1 = _s16(h1_test >> 12)
            if h1 > 0:
                tmp1_s32 = _s32((speech_prob[0] & 0xFFFFF000) << 2)
                sgprvec[channel] = _s16(_div_w32_w16(tmp1_s32, h1))
                sgprvec[channel + _NUM_CHANNELS] = 16384 - sgprvec[channel]

        vadflag |= int(sum_llr >= total_test)

        # Model update.
        maxspe = 12800
        for channel in range(_NUM_CHANNELS):
            feature_minimum = _find_minimum(self, features[channel], channel)
            noise_global_mean = _weighted_average(
                self.noise_means, channel, 0, _NOISE_DATA_WEIGHTS)
            tmp1_s16 = _s16(noise_global_mean >> 6)

            for k in range(_NUM_GAUSSIANS):
                gaussian = channel + k * _NUM_CHANNELS
                nmk = self.noise_means[gaussian]
                smk = self.speech_means[gaussian]
                nsk = self.noise_stds[gaussian]
                ssk = self.speech_stds[gaussian]

                nmk2 = nmk
                if not vadflag:
                    delt = _s16((ngprvec[gaussian] * deltaN[gaussian]) >> 11)
                    nmk2 = _s16(nmk + _s16((delt * _NOISE_UPDATE_CONST) >> 22))

                ndelt = _s16((feature_minimum << 4) - tmp1_s16)
                nmk3 = _s16(nmk2 + _s16((ndelt * _BACK_ETA) >> 9))
                lo = _s16((k + 5) << 7)
                if nmk3 < lo:
                    nmk3 = lo
                hi = _s16((72 + k - channel) << 7)
                if nmk3 > hi:
                    nmk3 = hi
                self.noise_means[gaussian] = nmk3

                if vadflag:
                    delt = _s16((sgprvec[gaussian] * deltaS[gaussian]) >> 11)
                    tmp_s16 = _s16((delt * _SPEECH_UPDATE_CONST) >> 21)
                    smk2 = _s16(smk + ((tmp_s16 + 1) >> 1))
                    maxmu = maxspe + 640
                    if smk2 < _MINIMUM_MEAN[k]:
                        smk2 = _MINIMUM_MEAN[k]
                    if smk2 > maxmu:
                        smk2 = maxmu
                    self.speech_means[gaussian] = smk2

                    tmp_s16 = (smk + 4) >> 3
                    tmp_s16 = _s16(features[channel] - tmp_s16)
                    tmp1_s32 = (deltaS[gaussian] * tmp_s16) >> 3
                    tmp2_s32 = _s32(tmp1_s32 - 4096)
                    tmp_s16 = sgprvec[gaussian] >> 2
                    tmp1_s32 = _s32(tmp_s16 * tmp2_s32)
                    tmp2_s32 = tmp1_s32 >> 4
                    if tmp2_s32 > 0:
                        tmp_s16 = _s16(_div_w32_w16(tmp2_s32, ssk * 10))
                    else:
                        tmp_s16 = _s16(-_s16(_div_w32_w16(-tmp2_s32, ssk * 10)))
                    tmp_s16 = _s16(tmp_s16 + 128)
                    ssk = _s16(ssk + (tmp_s16 >> 8))
                    if ssk < _MIN_STD:
                        ssk = _MIN_STD
                    self.speech_stds[gaussian] = ssk
                else:
                    tmp_s16 = _s16(features[channel] - (nmk >> 3))
                    tmp1_s32 = (deltaN[gaussian] * tmp_s16) >> 3
                    tmp1_s32 = _s32(tmp1_s32 - 4096)
                    tmp_s16 = (ngprvec[gaussian] + 2) >> 2
                    tmp2_s32 = _s32(tmp_s16 * tmp1_s32)
                    tmp1_s32 = tmp2_s32 >> 14
                    if tmp1_s32 > 0:
                        tmp_s16 = _s16(_div_w32_w16(tmp1_s32, nsk))
                    else:
                        tmp_s16 = _s16(-_s16(_div_w32_w16(-tmp1_s32, nsk)))
                    tmp_s16 = _s16(tmp_s16 + 32)
                    nsk = _s16(nsk + (tmp_s16 >> 6))
                    if nsk < _MIN_STD:
                        nsk = _MIN_STD
                    self.noise_stds[gaussian] = nsk

            # Separate models if they are too close.
            noise_global_mean = _weighted_average(
                self.noise_means, channel, 0, _NOISE_DATA_WEIGHTS)
            speech_global_mean = _weighted_average(
                self.speech_means, channel, 0, _SPEECH_DATA_WEIGHTS)
            diff = _s16(_s16(speech_global_mean >> 9)
                        - _s16(noise_global_mean >> 9))
            if diff < _MINIMUM_DIFFERENCE[channel]:
                tmp_s16 = _MINIMUM_DIFFERENCE[channel] - diff
                tmp1_s16 = _s16((13 * tmp_s16) >> 2)
                tmp2_s16 = _s16((3 * tmp_s16) >> 2)
                speech_global_mean = _weighted_average(
                    self.speech_means, channel, tmp1_s16, _SPEECH_DATA_WEIGHTS)
                noise_global_mean = _weighted_average(
                    self.noise_means, channel, -tmp2_s16, _NOISE_DATA_WEIGHTS)

            maxspe = _MAXIMUM_SPEECH[channel]
            tmp2_s16 = _s16(speech_global_mean >> 7)
            if tmp2_s16 > maxspe:
                tmp2_s16 = _s16(tmp2_s16 - maxspe)
                for k in range(_NUM_GAUSSIANS):
                    i = channel + k * _NUM_CHANNELS
                    self.speech_means[i] = _s16(self.speech_means[i] - tmp2_s16)
            tmp2_s16 = _s16(noise_global_mean >> 7)
            if tmp2_s16 > _MAXIMUM_NOISE[channel]:
                tmp2_s16 = _s16(tmp2_s16 - _MAXIMUM_NOISE[channel])
                for k in range(_NUM_GAUSSIANS):
                    i = channel + k * _NUM_CHANNELS
                    self.noise_means[i] = _s16(self.noise_means[i] - tmp2_s16)
        self.frame_counter += 1

    # Hangover smoothing.
    if not vadflag:
        if self.over_hang > 0:
            vadflag = 2 + self.over_hang
            self.over_hang -= 1
        self.num_of_speech = 0
    else:
        self.num_of_speech += 1
        if self.num_of_speech > _MAX_SPEECH_FRAMES:
            self.num_of_speech = _MAX_SPEECH_FRAMES
            self.over_hang = overhead2
        else:
            self.over_hang = overhead1
    return vadflag


# ---------------------------------------------------------------------------
# Downsampling (vad_sp.c) and the 48 kHz resampler chain
# ---------------------------------------------------------------------------

_ALLPASS_Q13 = (5243, 1392)


def _downsampling(signal_in, filter_state):
    """WebRtcVad_Downsampling: decimate by 2 with a Q13 allpass pair."""
    out = []
    tmp32_1 = filter_state[0]
    tmp32_2 = filter_state[1]
    half = len(signal_in) >> 1
    for n in range(half):
        x0 = signal_in[2 * n]
        x1 = signal_in[2 * n + 1]
        tmp16_1 = _s16((_s32(tmp32_1) >> 1) + ((_ALLPASS_Q13[0] * x0) >> 14))
        tmp32_1 = _s32(x0 - ((_ALLPASS_Q13[0] * tmp16_1) >> 12))
        tmp16_2 = _s16((_s32(tmp32_2) >> 1) + ((_ALLPASS_Q13[1] * x1) >> 14))
        tmp32_2 = _s32(x1 - ((_ALLPASS_Q13[1] * tmp16_2) >> 12))
        out.append(_s16(tmp16_1 + tmp16_2))
    filter_state[0] = tmp32_1
    filter_state[1] = tmp32_2
    return out


_RESAMPLE_ALLPASS = ((821, 6110, 12382), (3050, 9368, 15063))
_COEFFS_48_TO_32 = ((778, -2050, 1087, 23285, 12903, -3783, 441, 222),
                    (222, 441, -3783, 12903, 23285, 1087, -2050, 778))


def _allpass3(tmp0, state, base, coefs, round_first=True):
    """One 3-stage allpass step shared by the resample-by-2 kernels.

    Matches resample_by_2_internal.c: first stage rounds, later stages
    truncate toward -inf then add 1 if negative (truncation toward zero
    of the >>14).  Returns the updated state; output is state[base+3].
    """
    diff = _s32(tmp0 - state[base + 1])
    diff = _s32(diff + (1 << 13)) >> 14
    tmp1 = _s32(state[base] + diff * coefs[0])
    state[base] = tmp0
    diff = _s32(tmp1 - state[base + 2])
    diff = diff >> 14
    if diff < 0:
        diff += 1
    tmp0b = _s32(state[base + 1] + diff * coefs[1])
    state[base + 1] = tmp1
    diff = _s32(tmp0b - state[base + 3])
    diff = diff >> 14
    if diff < 0:
        diff += 1
    state[base + 3] = _s32(state[base + 2] + diff * coefs[2])
    state[base + 2] = tmp0b
    return state[base + 3]


def _down_by_2_short_to_int(inp, state):
    """int16 -> int32(<<15 + 16384) decimation by 2."""
    half = len(inp) >> 1
    out = [0] * half
    for i in range(half):
        tmp0 = _s32((inp[2 * i] << 15) + (1 << 14))
        out[i] = _allpass3(tmp0, state, 0, _RESAMPLE_ALLPASS[1]) >> 1
    for i in range(half):
        tmp0 = _s32((inp[2 * i + 1] << 15) + (1 << 14))
        out[i] = _s32(out[i] + (_allpass3(tmp0, state, 4, _RESAMPLE_ALLPASS[0]) >> 1))
    return out


def _down_by_2_int_to_short(inp, state):
    """int32 -> int16 decimation by 2 (with the in-place combine step)."""
    half = len(inp) >> 1
    buf = list(inp)
    for i in range(half):
        buf[2 * i] = _allpass3(buf[2 * i], state, 0, _RESAMPLE_ALLPASS[1]) >> 1
    for i in range(half):
        buf[2 * i + 1] = _allpass3(buf[2 * i + 1], state, 4,
                                   _RESAMPLE_ALLPASS[0]) >> 1
    out = [0] * half
    for i in range(0, half, 2):
        tmp0 = _s32(buf[2 * i] + buf[2 * i + 1]) >> 15
        out[i] = min(max(tmp0, -0x8000), 0x7FFF)
        if i + 1 < half:
            tmp1 = _s32(buf[2 * i + 2] + buf[2 * i + 3]) >> 15
            out[i + 1] = min(max(tmp1, -0x8000), 0x7FFF)
    return out


def _lp_by_2_int_to_int(inp, state):
    """int32 -> int32 half-band lowpass (WebRtcSpl_LPBy2IntToInt)."""
    half = len(inp) >> 1
    out = [0] * len(inp)
    # lower allpass: odd input -> even output
    tmp0 = state[12]
    for i in range(half):
        out[2 * i] = _allpass3(tmp0, state, 0, _RESAMPLE_ALLPASS[1]) >> 1
        tmp0 = inp[2 * i + 1]
    # upper allpass: even input -> even output
    for i in range(half):
        v = _allpass3(inp[2 * i], state, 4, _RESAMPLE_ALLPASS[0]) >> 1
        out[2 * i] = _s32(out[2 * i] + v) >> 15
    # lower allpass: even input -> odd output
    for i in range(half):
        out[2 * i + 1] = _allpass3(inp[2 * i], state, 8,
                                   _RESAMPLE_ALLPASS[1]) >> 1
    # upper allpass: odd input -> odd output
    for i in range(half):
        v = _allpass3(inp[2 * i + 1], state, 12, _RESAMPLE_ALLPASS[0]) >> 1
        out[2 * i + 1] = _s32(out[2 * i + 1] + v) >> 15
    return out


def _resample_48_to_32(inp, k):
    """3 -> 2 fractional resampling over K blocks (needs 8-tap history)."""
    out = []
    pos = 0
    for _ in range(k):
        for row in range(2):
            tmp = 1 << 14
            for j in range(8):
                tmp = _s32(tmp + _COEFFS_48_TO_32[row][j] * inp[pos + row + j])
            out.append(tmp)
        pos += 3
    return out


class _Resampler48To8:
    """WebRtcSpl_Resample48khzTo8khz state + one 480-sample step."""

    def __init__(self):
        self.s_48_24 = [0] * 8
        self.s_24_24 = [0] * 16
        self.s_24_16 = [0] * 8
        self.s_16_8 = [0] * 8

    def process(self, in480):
        t24 = _down_by_2_short_to_int(in480, self.s_48_24)       # 240 int32
        t24lp = _lp_by_2_int_to_int(t24, self.s_24_24)           # 240 int32
        buf = self.s_24_16 + t24lp                               # 8 history + 240
        self.s_24_16 = t24lp[-8:]
        t16 = _resample_48_to_32(buf, 80)                        # 160 int32
        return _down_by_2_int_to_short(t16, self.s_16_8)         # 80 int16


# ---------------------------------------------------------------------------
# Core VAD object (VadInstT + WebRtcVad_Process)
# ---------------------------------------------------------------------------


class VadCore:
    """State-holding equivalent of VadInstT (vad_core.h) + the public
    WebRtcVad_Process entry point."""

    def __init__(self, mode: int = 0):
        self.vad = 1
        self.frame_counter = 0
        self.over_hang = 0
        self.num_of_speech = 0
        self.downsampling_filter_states = [0, 0, 0, 0]
        self.state_48_to_8 = _Resampler48To8()
        self.noise_means = list(_NOISE_DATA_MEANS)
        self.speech_means = list(_SPEECH_DATA_MEANS)
        self.noise_stds = list(_NOISE_DATA_STDS)
        self.speech_stds = list(_SPEECH_DATA_STDS)
        self.low_value_vector = [10000] * (16 * _NUM_CHANNELS)
        self.index_vector = [0] * (16 * _NUM_CHANNELS)
        self.upper_state = [0] * 5
        self.lower_state = [0] * 5
        self.hp_filter_state = [0] * 4
        self.mean_value = [1600] * _NUM_CHANNELS
        self.set_mode(mode)

    def set_mode(self, mode: int):
        if mode not in _MODE_TABLES:
            raise ValueError(f"invalid VAD mode {mode}")
        (self.over_hang_max_1, self.over_hang_max_2,
         self.individual, self.total) = _MODE_TABLES[mode]
        self.mode = mode

    # -- per-rate entry points (vad_core.c CalcVad*) --

    def _calc_vad_8khz(self, frame):
        total_power, features = _calculate_features(self, frame)
        self.vad = _gmm_probability(self, features, total_power, len(frame))
        return self.vad

    def _calc_vad_16khz(self, frame):
        nb = _downsampling(frame, self.downsampling_filter_states)
        return self._calc_vad_8khz(nb)

    def _calc_vad_32khz(self, frame):
        # 32 -> 16 uses filter states [2:4], 16 -> 8 uses [0:2]
        # (vad_core.c WebRtcVad_CalcVad32khz).
        st = self.downsampling_filter_states
        wb_state = st[2:4]
        wb = _downsampling(frame, wb_state)
        st[2], st[3] = wb_state
        nb_state = st[0:2]
        nb = _downsampling(wb, nb_state)
        st[0], st[1] = nb_state
        return self._calc_vad_8khz(nb)

    def _calc_vad_48khz(self, frame):
        # Quirk preserved from the reference (vad_core.c:619-624,
        # inherited from upstream WebRTC): the resample loop never
        # advances the input pointer, so every 10 ms sub-frame resamples
        # the SAME first 480 samples (with carried resampler state).
        # Bit-exactness for 20/30 ms frames requires reproducing this.
        nb = []
        for _ in range(len(frame) // 480):
            nb.extend(self.state_48_to_8.process(frame[:480]))
        return self._calc_vad_8khz(nb[: len(frame) // 6])

    def process(self, fs: int, frame) -> int:
        """WebRtcVad_Process: returns 1 (speech), 0 (non-speech), -1."""
        frame = frame_to_list(frame)
        if not valid_rate_and_frame_length(fs, len(frame)):
            return -1
        if fs == 48000:
            vad = self._calc_vad_48khz(frame)
        elif fs == 32000:
            vad = self._calc_vad_32khz(frame)
        elif fs == 16000:
            vad = self._calc_vad_16khz(frame)
        else:
            vad = self._calc_vad_8khz(frame)
        return 1 if vad > 0 else vad


def frame_to_list(frame):
    if isinstance(frame, list):
        return frame
    a = np.asarray(frame)
    if a.dtype != np.int16:
        a = a.astype(np.int16)
    return [int(x) for x in a]


def valid_rate_and_frame_length(rate: int, frame_length: int) -> bool:
    if rate not in (8000, 16000, 32000, 48000):
        return False
    return frame_length in tuple((rate // 1000) * ms for ms in (10, 20, 30))
