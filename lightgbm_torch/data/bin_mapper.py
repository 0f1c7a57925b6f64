"""Per-feature value -> bin discretization (numerical features).

The port's own copy of the JAX package's BinMapper
(lightgbm_tpu/data/bin_mapper.py), which rebuilds the reference BinMapper
(include/LightGBM/bin.h:61-219, src/io/bin.cpp): GreedyFindBin bin.cpp:79,
FindBinWithZeroAsOneBin bin.cpp:257, FindBinWithPredefinedBin bin.cpp:158,
BinMapper::FindBin bin.cpp:326, NeedFilter bin.cpp:55, ValueToBin bin.h:522.
Host-side numpy; the boundaries drive a vectorized `value_to_bin` that
produces the uint8 bin matrix the kernels read on the card.

Categorical features are not part of this slice of the port: the Dataset
refuses them before any mapper is built, so only the numerical branch of
the reference is kept here.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


# reference include/LightGBM/meta.h:53
kZeroThreshold = 1e-35
# reference include/LightGBM/bin.h:39
kSparseThreshold = 0.7


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


def _check_double_equal_ordered(a: float, b: float) -> bool:
    # reference common.h:889
    return b <= np.nextafter(a, np.inf)


def _double_upper_bound(a: float) -> float:
    # reference common.h:894
    return float(np.nextafter(a, np.inf))


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    num_distinct_values: int, max_bin: int,
                    total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy bin-boundary search; reference bin.cpp:79-156."""
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct_values <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            cur_cnt_inbin += counts[i]
            if cur_cnt_inbin >= min_data_in_bin:
                val = _double_upper_bound((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
    else:
        if min_data_in_bin > 0:
            max_bin = min(max_bin, total_cnt // min_data_in_bin)
            max_bin = max(max_bin, 1)
        mean_bin_size = total_cnt / max_bin
        n = num_distinct_values
        cnts = np.asarray(counts[:n], dtype=np.int64)
        is_big = cnts >= mean_bin_size
        rest_bin_cnt = max_bin - int(np.count_nonzero(is_big))
        init_rest = int(total_cnt) - int(cnts[is_big].sum())
        mean_bin_size = init_rest / rest_bin_cnt if rest_bin_cnt else math.inf

        # The boundary walk is sequential, but between boundaries nothing
        # changes: the next stop is the earliest of (first big value),
        # (prefix count reaching mean_bin_size), (value preceding a big one
        # once half a bin has accumulated). Each is a sorted-array lookup, so
        # the walk costs O(max_bin log n) instead of a Python loop over every
        # distinct value.
        prefix = np.cumsum(cnts)                       # [n]
        # float copy for the threshold lookups: comparing an int array
        # against a float target would silently convert the whole array
        # per searchsorted call (sample counts are < 2^53, so exact)
        prefix_f = prefix.astype(np.float64)
        small_prefix = np.cumsum(np.where(is_big, 0, cnts))
        big_idx = np.nonzero(is_big)[0]

        upper_bounds = []
        lower_bounds = [distinct_values[0]]
        bin_cnt = 0
        seg = 0                                        # first index of segment
        while seg <= n - 2:
            base = int(prefix[seg - 1]) if seg > 0 else 0
            j = np.searchsorted(big_idx, seg, side="left")
            i_a = int(big_idx[j]) if j < len(big_idx) else n
            i_b = int(np.searchsorted(prefix_f, base + mean_bin_size,
                                      side="left"))
            t_half = max(1.0, mean_bin_size * np.float32(0.5))
            pos_h = int(np.searchsorted(prefix_f, base + t_half, side="left"))
            jc = np.searchsorted(big_idx, max(seg, pos_h) + 1, side="left")
            i_c = int(big_idx[jc]) - 1 if jc < len(big_idx) else n
            stop = min(i_a, i_b, i_c)
            if stop > n - 2:
                break
            upper_bounds.append(distinct_values[stop])
            bin_cnt += 1
            lower_bounds.append(distinct_values[stop + 1])
            if bin_cnt >= max_bin - 1:
                break
            if not is_big[stop]:
                rest_bin_cnt -= 1
                rest = init_rest - int(small_prefix[stop])
                mean_bin_size = rest / rest_bin_cnt if rest_bin_cnt else math.inf
            seg = stop + 1
        bin_cnt += 1
        for i in range(bin_cnt - 1):
            val = _double_upper_bound((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
            if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
                bin_upper_bound.append(val)
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _find_bin_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                              num_distinct_values: int, max_bin: int,
                              total_sample_cnt: int, min_data_in_bin: int) -> List[float]:
    """Zero gets its own bin; reference bin.cpp:257-313."""
    bin_upper_bound: List[float] = []
    dv = distinct_values[:num_distinct_values]
    ct = counts[:num_distinct_values]
    left_mask = dv <= -kZeroThreshold
    right_mask = dv > kZeroThreshold
    left_cnt_data = int(ct[left_mask].sum())
    right_cnt_data = int(ct[right_mask].sum())
    cnt_zero = int(total_sample_cnt) - left_cnt_data - right_cnt_data

    nz = np.nonzero(dv > -kZeroThreshold)[0]
    left_cnt = int(nz[0]) if len(nz) else num_distinct_values

    if left_cnt > 0 and max_bin > 1:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1)) if denom else 1
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = greedy_find_bin(dv, ct, left_cnt, left_max_bin,
                                          left_cnt_data, min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -kZeroThreshold

    nz = np.nonzero(dv[left_cnt:] > kZeroThreshold)[0]
    right_start = int(nz[0]) + left_cnt if len(nz) else -1

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(dv[right_start:], ct[right_start:],
                                       num_distinct_values - right_start,
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(kZeroThreshold)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _find_bin_with_predefined(distinct_values: np.ndarray, counts: np.ndarray,
                              num_distinct_values: int, max_bin: int,
                              total_sample_cnt: int, min_data_in_bin: int,
                              forced_upper_bounds: Sequence[float]) -> List[float]:
    """Forced bin boundaries (forcedbins_filename); reference bin.cpp:158-255."""
    dv = distinct_values[:num_distinct_values]
    left_cnt = num_distinct_values
    nz = np.nonzero(dv > -kZeroThreshold)[0]
    if len(nz):
        left_cnt = int(nz[0])
    nz = np.nonzero(dv[left_cnt:] > kZeroThreshold)[0]
    right_start = int(nz[0]) + left_cnt if len(nz) else -1

    bin_upper_bound: List[float] = []
    if max_bin == 2:
        bin_upper_bound.append(kZeroThreshold if left_cnt == 0 else -kZeroThreshold)
    elif max_bin >= 3:
        if left_cnt > 0:
            bin_upper_bound.append(-kZeroThreshold)
        if right_start >= 0:
            bin_upper_bound.append(kZeroThreshold)
    bin_upper_bound.append(math.inf)

    max_to_insert = max_bin - len(bin_upper_bound)
    num_inserted = 0
    for b in forced_upper_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(b) > kZeroThreshold:
            bin_upper_bound.append(float(b))
            num_inserted += 1
    bin_upper_bound.sort()

    free_bins = max_bin - len(bin_upper_bound)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_fixed = len(bin_upper_bound)
    for i in range(n_fixed):
        cnt_in_bin = 0
        distinct_cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < num_distinct_values and dv[value_ind] < bin_upper_bound[i]:
            cnt_in_bin += int(counts[value_ind])
            distinct_cnt_in_bin += 1
            value_ind += 1
        bins_remaining = max_bin - n_fixed - len(bounds_to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / total_sample_cnt))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_fixed - 1:
            num_sub_bins = bins_remaining + 1
        if distinct_cnt_in_bin > 0:
            new_bounds = greedy_find_bin(dv[bin_start:], counts[bin_start:],
                                         distinct_cnt_in_bin, num_sub_bins,
                                         cnt_in_bin, min_data_in_bin)
            bounds_to_add.extend(new_bounds[:-1])  # last bound is inf
    bin_upper_bound.extend(bounds_to_add)
    bin_upper_bound.sort()
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def find_bin_bounds(distinct_values, counts, num_distinct_values, max_bin,
                    total_sample_cnt, min_data_in_bin, forced_upper_bounds=()):
    if len(forced_upper_bounds) == 0:
        return _find_bin_zero_as_one_bin(distinct_values, counts, num_distinct_values,
                                         max_bin, total_sample_cnt, min_data_in_bin)
    return _find_bin_with_predefined(distinct_values, counts, num_distinct_values,
                                     max_bin, total_sample_cnt, min_data_in_bin,
                                     forced_upper_bounds)


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int, filter_cnt: int) -> bool:
    """True if no split on this numerical feature could satisfy min counts;
    bin.cpp:55-77."""
    sum_left = np.cumsum(cnt_in_bin[:-1])
    ok = (sum_left >= filter_cnt) & (total_cnt - sum_left >= filter_cnt)
    return not bool(ok.any())


class BinMapper:
    """Feature discretizer; mirrors reference BinMapper state (bin.h:61-219)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int, pre_filter: bool,
                 use_missing: bool = True,
                 zero_as_missing: bool = False,
                 forced_upper_bounds: Sequence[float] = ()) -> None:
        """Compute bin boundaries from sampled non-zero values.

        `values` are the sampled values EXCLUDING implicit zeros (the reference
        sampling stores only non-zero entries; zero count is inferred from
        total_sample_cnt). NaNs may be present. Reference bin.cpp:326-533.
        """
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]
        num_sample_values = len(values) + na_cnt

        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NONE if na_cnt == 0 else MissingType.NAN
        if self.missing_type != MissingType.NAN:
            # reference bin.cpp:330-353: na_cnt stays 0 outside the NaN branch,
            # so stripped NaNs are counted into zero_cnt (they bin as zero)
            na_cnt = 0
        n_values = len(values)

        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - n_values - na_cnt)

        # distinct values with 1-ulp merging (larger value kept); bin.cpp:354-390
        values = np.sort(values, kind="stable")
        if n_values > 0:
            new_group = np.empty(n_values, dtype=bool)
            new_group[0] = True
            if n_values > 1:
                new_group[1:] = values[1:] > np.nextafter(values[:-1], np.inf)
            group_idx = np.nonzero(new_group)[0]
            # distinct value is the last (largest) member of each run
            end_idx = np.append(group_idx[1:], n_values) - 1
            dvals = values[end_idx]
            dcnts = np.diff(np.append(group_idx, n_values))
        else:
            dvals = np.empty(0)
            dcnts = np.empty(0, dtype=np.int64)

        # insert the implicit zero (stripped by sampling) into the sorted
        # distinct list: before positives / between sign change / after
        # negatives — the sign-change insert happens even at zero_cnt == 0
        if n_values == 0:
            dv_arr = np.array([0.0])
            ct_arr = np.array([max(zero_cnt, 0)], dtype=np.int64)
        else:
            pos0 = int(np.searchsorted(dvals, 0.0, side="left"))
            if pos0 == 0:
                insert = zero_cnt > 0 and dvals[0] > 0.0
            elif pos0 == len(dvals):
                insert = zero_cnt > 0 and dvals[-1] < 0.0
            else:
                insert = dvals[pos0 - 1] < 0.0 and dvals[pos0] > 0.0
            if insert:
                dv_arr = np.insert(dvals, pos0, 0.0)
                ct_arr = np.insert(dcnts.astype(np.int64), pos0, zero_cnt)
            else:
                dv_arr = dvals
                ct_arr = dcnts.astype(np.int64)
        distinct_values = dv_arr
        counts = ct_arr
        # NOTE: when sampled values contain exact 0.0 runs the reference counted
        # them in-place; our caller strips zeros, so implicit-zero insertion above
        # is the only zero source (matches dataset_loader's non-zero sampling).

        self.min_val = float(distinct_values[0])
        self.max_val = float(distinct_values[-1])
        dv = np.asarray(distinct_values)
        ct = np.asarray(counts, dtype=np.int64)
        num_distinct_values = len(dv)

        if self.missing_type == MissingType.ZERO:
            bounds = find_bin_bounds(dv, ct, num_distinct_values, max_bin,
                                     total_sample_cnt, min_data_in_bin,
                                     forced_upper_bounds)
            if len(bounds) == 2:
                self.missing_type = MissingType.NONE
        elif self.missing_type == MissingType.NONE:
            bounds = find_bin_bounds(dv, ct, num_distinct_values, max_bin,
                                     total_sample_cnt, min_data_in_bin,
                                     forced_upper_bounds)
        else:
            bounds = find_bin_bounds(dv, ct, num_distinct_values, max_bin - 1,
                                     total_sample_cnt - na_cnt, min_data_in_bin,
                                     forced_upper_bounds)
            bounds = list(bounds) + [math.nan]
        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(bounds)
        # count per bin; bin.cpp:411-423
        n_search = self.num_bin - (1 if self.missing_type == MissingType.NAN else 0)
        search_bounds = self.bin_upper_bound[:n_search]
        idx = np.searchsorted(search_bounds, dv, side="left")
        idx = np.minimum(idx, n_search - 1)
        cnt_in_bin = np.bincount(idx, weights=ct, minlength=self.num_bin).astype(np.int64)
        if self.missing_type == MissingType.NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        assert self.num_bin <= max_bin
        # trivial / filter / most_freq; bin.cpp:499-533
        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and \
                _need_filter(cnt_in_bin, int(total_sample_cnt), min_split_data):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(np.array([0.0]))[0])
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = float(cnt_in_bin[self.most_freq_bin]) / total_sample_cnt
            if self.most_freq_bin != self.default_bin and max_sparse_rate < kSparseThreshold:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = float(cnt_in_bin[self.most_freq_bin]) / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    # ------------------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference bin.h:522-556 binary search)."""
        values = np.asarray(values, dtype=np.float64)
        out = np.zeros(values.shape, dtype=np.int32)
        nan_mask = np.isnan(values)
        v = np.where(nan_mask, 0.0, values)
        n_search = self.num_bin - (1 if self.missing_type == MissingType.NAN else 0)
        bounds = self.bin_upper_bound[:n_search]
        out = np.searchsorted(bounds, v, side="left").astype(np.int32)
        out = np.minimum(out, n_search - 1)
        if self.missing_type == MissingType.NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative value of a bin: its upper bound."""
        return float(self.bin_upper_bound[bin_idx])
