"""Per-feature value -> bin discretization.

The port's own copy of the JAX package's BinMapper
(lightgbm_tpu/data/bin_mapper.py), which rebuilds the reference BinMapper
(include/LightGBM/bin.h:61-219, src/io/bin.cpp): GreedyFindBin bin.cpp:79,
FindBinWithZeroAsOneBin bin.cpp:257, FindBinWithPredefinedBin bin.cpp:158,
BinMapper::FindBin bin.cpp:326, NeedFilter bin.cpp:55, ValueToBin bin.h:522.
Host-side numpy; the boundaries drive a vectorized `value_to_bin` that
produces the uint8 bin matrix the kernels read on the card.

Categorical features follow the reference's categorical branch
(bin.cpp:425-533; the JAX package's bin_mapper.py:393-470): negative
values count as NaN, categories take bins in order of falling count (a
category 0 first swaps with the second), up to ``max_bin`` and past the
99% cut only while bins remain, a NaN bin when NaN was seen and every
category fits, and the most frequent bin is never bin 0.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..utils.log import Log


# reference include/LightGBM/meta.h:53
kZeroThreshold = 1e-35
# reference include/LightGBM/bin.h:39
kSparseThreshold = 0.7


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1


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


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """True if no split on this feature could satisfy min counts;
    bin.cpp:55-77."""
    if bin_type == BinType.NUMERICAL:
        sum_left = np.cumsum(cnt_in_bin[:-1])
        ok = (sum_left >= filter_cnt) & (total_cnt - sum_left >= filter_cnt)
        return not bool(ok.any())
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            sum_left = int(cnt_in_bin[i])
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Feature discretizer; mirrors reference BinMapper state (bin.h:61-219)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BinType.NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.categorical_2_bin: Dict[int, int] = {}
        self.bin_2_categorical: List[int] = []
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int, pre_filter: bool,
                 bin_type: int = BinType.NUMERICAL, use_missing: bool = True,
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

        self.bin_type = bin_type
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

        if bin_type == BinType.NUMERICAL:
            cnt_in_bin = self._numerical_bins(
                dv, ct, max_bin, total_sample_cnt, min_data_in_bin, na_cnt,
                forced_upper_bounds)
        else:
            cnt_in_bin = self._categorical_bins(
                dv, ct, max_bin, total_sample_cnt, min_data_in_bin, na_cnt)
        # trivial / filter / most_freq; bin.cpp:499-533
        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and \
                _need_filter(cnt_in_bin, int(total_sample_cnt), min_split_data,
                             bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(np.array([0.0]))[0])
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            if bin_type == BinType.CATEGORICAL and self.most_freq_bin == 0:
                assert self.num_bin > 1
                self.most_freq_bin = 1
            max_sparse_rate = float(cnt_in_bin[self.most_freq_bin]) / total_sample_cnt
            if self.most_freq_bin != self.default_bin and max_sparse_rate < kSparseThreshold:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = float(cnt_in_bin[self.most_freq_bin]) / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    # ------------------------------------------------------------------
    def _numerical_bins(self, dv, ct, max_bin, total_sample_cnt,
                        min_data_in_bin, na_cnt, forced_upper_bounds
                        ) -> np.ndarray:
        """Bin boundaries of a numerical feature; the count per bin
        (bin.cpp:395-423)."""
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
        n_search = self.num_bin - (1 if self.missing_type == MissingType.NAN
                                   else 0)
        search_bounds = self.bin_upper_bound[:n_search]
        idx = np.searchsorted(search_bounds, dv, side="left")
        idx = np.minimum(idx, n_search - 1)
        cnt_in_bin = np.bincount(idx, weights=ct, minlength=self.num_bin
                                 ).astype(np.int64)
        if self.missing_type == MissingType.NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        assert self.num_bin <= max_bin
        return cnt_in_bin

    def _categorical_bins(self, dv, ct, max_bin, total_sample_cnt,
                          min_data_in_bin, na_cnt) -> np.ndarray:
        """Category -> bin map of a categorical feature; the count per bin
        (bin.cpp:425-497)."""
        dvi: List[int] = []
        cti: List[int] = []
        for v, c in zip(dv, ct):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                Log.warning("Met negative value in categorical features, "
                            "will convert it to NaN")
            elif not dvi or iv != dvi[-1]:
                dvi.append(iv)
                cti.append(int(c))
            else:
                cti[-1] += int(c)
        self.num_bin = 0
        rest_cnt = int(total_sample_cnt - na_cnt)
        if rest_cnt <= 0:
            return np.zeros(0, dtype=np.int64)
        if dvi and dvi[-1] // 100 > len(dvi):
            Log.warning("Met categorical feature which contains sparse "
                        "values. Consider renumbering to consecutive "
                        "integers started from zero")
        order = sorted(range(len(cti)), key=lambda i: -cti[i])
        cti = [cti[i] for i in order]
        dvi = [dvi[i] for i in order]
        if dvi and dvi[0] == 0:
            if len(cti) == 1:
                cti.append(0)
                dvi.append(dvi[0] + 1)
            cti[0], cti[1] = cti[1], cti[0]
            dvi[0], dvi[1] = dvi[1], dvi[0]
        cut_cnt = int((total_sample_cnt - na_cnt) * np.float32(0.99))
        cur_cat = 0
        self.categorical_2_bin = {}
        self.bin_2_categorical = []
        used_cnt = 0
        max_bin = min(len(dvi), max_bin)
        cib: List[int] = []
        while cur_cat < len(dvi) and (used_cnt < cut_cnt
                                      or self.num_bin < max_bin):
            if cti[cur_cat] < min_data_in_bin and cur_cat > 1:
                break
            self.bin_2_categorical.append(dvi[cur_cat])
            self.categorical_2_bin[dvi[cur_cat]] = self.num_bin
            used_cnt += cti[cur_cat]
            cib.append(cti[cur_cat])
            self.num_bin += 1
            cur_cat += 1
        if cur_cat == len(dvi) and na_cnt > 0:
            self.bin_2_categorical.append(-1)
            self.categorical_2_bin[-1] = self.num_bin
            cib.append(0)
            self.num_bin += 1
        if cur_cat == len(dvi) and na_cnt == 0:
            self.missing_type = MissingType.NONE
        else:
            self.missing_type = MissingType.NAN
        if cib:
            cib[-1] += int(total_sample_cnt - used_cnt)
        return np.asarray(cib, dtype=np.int64)

    # ------------------------------------------------------------------
    def categorical_lut(self) -> np.ndarray:
        """Dense category -> bin lookup table; a category past its end, a
        negative value and NaN take bin num_bin - 1 (the JAX package's
        bin_mapper.py:473)."""
        lut_size = max([k for k in self.categorical_2_bin] or [0]) + 2
        lut = np.full(lut_size, self.num_bin - 1, dtype=np.int32)
        for k, b in self.categorical_2_bin.items():
            if k >= 0:
                lut[k] = b
        return lut

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference bin.h:522-556 binary search)."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        if self.bin_type == BinType.CATEGORICAL:
            # values truncate toward zero; NaN, +-inf and negatives are -1
            iv = np.where(nan_mask, -1, np.where(np.isfinite(values), values,
                                                 -1)).astype(np.int64)
            lut = self.categorical_lut()
            bad = (iv < 0) | (iv >= len(lut))
            return np.where(bad, self.num_bin - 1,
                            lut[np.clip(iv, 0, len(lut) - 1)]).astype(np.int32)
        v = np.where(nan_mask, 0.0, values)
        n_search = self.num_bin - (1 if self.missing_type == MissingType.NAN else 0)
        bounds = self.bin_upper_bound[:n_search]
        out = np.searchsorted(bounds, v, side="left").astype(np.int32)
        out = np.minimum(out, n_search - 1)
        if self.missing_type == MissingType.NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative value of a bin: its upper bound (categorical: its
        category)."""
        if self.bin_type == BinType.CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    @property
    def is_categorical(self) -> bool:
        return self.bin_type == BinType.CATEGORICAL
