"""Binned training dataset: host-side construction, device-side layout.

The port's own copy of the dense route of the JAX package's BinnedDataset
(lightgbm_tpu/data/dataset.py): row sampling, one BinMapper per feature,
EFB grouping, the group layout, and numpy binning into one dense
``[num_data, num_groups]`` uint8 matrix of group-local bins. The grouping
is the JAX package's, so both packages see the same layout for the same
data and config.

Categorical columns (``categorical_features``, inner ids in
``is_categorical``) bin with the reference's categorical mapper; EFB may
bundle them like any feature.

``to_device`` hands the grower that matrix and the per-feature metadata as
tensors on the chosen device (:class:`DeviceData`).

Not in this slice (ROADMAP.md queue A): sparse and file ingest, the
multi-value (ELL) layout and 4-bit packing (the JAX package's storage
detail: the port always stores one byte per group, which gives the same
trees). EFB-bundled datasets train on the persistent grower only (its
scan_blocks applies FixHistogram); the v1 grower refuses them.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..utils.log import Log
from .bin_mapper import BinMapper, BinType, kZeroThreshold

MAX_GROUP_BINS = 256  # keep bundled groups addressable by uint8


class DeviceData(NamedTuple):
    """What the grower reads, as tensors on one device."""
    bins: torch.Tensor           # [N, G] uint8 group-local bins
    group_offset: torch.Tensor   # [G] i32 global bin offset per group
    group_of: torch.Tensor       # [F] i32 feature -> group
    bin_start: torch.Tensor      # [F] i32 global bin range start
    bin_end: torch.Tensor        # [F] i32 global bin range end (exclusive)
    missing_type: torch.Tensor   # [F] i32 (0 none, 1 zero, 2 nan)
    default_bin: torch.Tensor    # [F] i32 local bin of value 0.0
    most_freq_bin: torch.Tensor  # [F] i32 local most frequent bin


class Metadata:
    """Labels, weights, query boundaries and initial scores (reference
    dataset.h:41; the JAX package's data/dataset.py:35-96)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # [nq+1] int32
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            Log.fatal("Length of label (%d) != num_data (%d)"
                      % (len(label), self.num_data))
        self.label = label

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.ascontiguousarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            Log.fatal("Length of weight (%d) != num_data (%d)"
                      % (len(weight), self.num_data))
        self.weight = weight

    def set_query(self, group) -> None:
        """group: per-query sizes (LightGBM convention) or boundaries."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        if group.sum() == self.num_data:
            self.query_boundaries = np.concatenate(
                [[0], np.cumsum(group)]).astype(np.int32)
        elif len(group) and group[0] == 0 and group[-1] == self.num_data:
            self.query_boundaries = group.astype(np.int32)
        else:
            Log.fatal("Sum of query counts (%d) != num_data (%d)"
                      % (group.sum(), self.num_data))

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.ascontiguousarray(
            init_score, dtype=np.float64).reshape(-1)

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    @property
    def query_weights(self) -> Optional[np.ndarray]:
        """Mean row weight per query (Metadata::LoadQueryWeights,
        src/io/metadata.cpp:455-469); None without weights or queries."""
        if self.weight is None or self.query_boundaries is None:
            return None
        qb = self.query_boundaries
        sums = np.add.reduceat(self.weight.astype(np.float64), qb[:-1])
        return (sums / np.diff(qb)).astype(np.float32)


def _sample_data(X: np.ndarray, sample_cnt: int, seed: int) -> np.ndarray:
    n = X.shape[0]
    if n <= sample_cnt:
        return X
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=sample_cnt, replace=False)
    idx.sort()
    return X[idx]


def _greedy_bundle(nonzero_masks: List[np.ndarray], order: List[int],
                   num_bins: List[int], max_conflict_cnt: int
                   ) -> List[List[int]]:
    """Greedy conflict-bounded bundling (reference FindGroups,
    src/io/dataset.cpp:97-234, as simplified by the JAX package: no GPU bin
    cap branch, no random search-group subsampling)."""
    groups: List[List[int]] = []
    marks: List[np.ndarray] = []
    conflict_used: List[int] = []
    group_bins: List[int] = []
    for fidx in order:
        nz = nonzero_masks[fidx]
        cnt = int(nz.sum())
        placed = False
        for gid in range(len(groups)):
            if group_bins[gid] + num_bins[fidx] + 1 > MAX_GROUP_BINS:
                continue
            rest = max_conflict_cnt - conflict_used[gid]
            if rest < 0:
                continue
            conflict = int((marks[gid] & nz).sum())
            if conflict <= rest and conflict <= cnt // 2:
                groups[gid].append(fidx)
                marks[gid] |= nz
                conflict_used[gid] += conflict
                group_bins[gid] += num_bins[fidx]
                placed = True
                break
        if not placed:
            groups.append([fidx])
            marks.append(nz.copy())
            conflict_used.append(0)
            group_bins.append(num_bins[fidx] + 1)
    return groups


def nibble_slot_partition(widths):
    """(wide, pairs, leftover): the 4-bit slot assignment of the JAX
    package's payload plan (lightgbm_tpu/data/dataset.py:157). Groups of at
    most 16 bins pair up two per byte slot, in group order; an odd one out
    takes a byte slot alone; the rest keep full byte slots."""
    G = len(widths)
    narrow = [g for g in range(G) if widths[g] <= 16]
    wide = [g for g in range(G) if widths[g] > 16]
    pairs = [(narrow[i], narrow[i + 1])
             for i in range(0, len(narrow) - 1, 2)]
    leftover = narrow[-1] if len(narrow) % 2 else None
    return wide, pairs, leftover


def _load_forced_bins(filename: str) -> Dict[int, List[float]]:
    """forcedbins_filename JSON: [{"feature": i, "bin_upper_bound": [...]}]."""
    if not filename:
        return {}
    import json
    with open(filename) as fh:
        spec = json.load(fh)
    return {int(e["feature"]): [float(x) for x in e["bin_upper_bound"]]
            for e in spec}


class BinnedDataset:
    """The binned training matrix + per-feature metadata (dataset.h:333)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.bin_mappers: List[BinMapper] = []        # per original feature
        self.used_features: List[int] = []            # original idx, non-trivial
        self.inner_of: Dict[int, int] = {}            # original -> inner
        self.groups: List[List[int]] = []             # inner feature ids
        self.metadata: Optional[Metadata] = None
        self.binned: Optional[np.ndarray] = None      # [N, G] uint8
        self.group_offset: Optional[np.ndarray] = None  # [G] i32
        self.group_of: Optional[np.ndarray] = None    # [F_inner] i32
        self.bin_start: Optional[np.ndarray] = None   # [F_inner] i32 global
        self.bin_end: Optional[np.ndarray] = None
        self.most_freq_bin: Optional[np.ndarray] = None
        self.default_bin: Optional[np.ndarray] = None
        self.missing_type_arr: Optional[np.ndarray] = None
        self.is_categorical: Optional[np.ndarray] = None  # [F_inner] bool
        self.monotone: Optional[np.ndarray] = None
        self.penalty: Optional[np.ndarray] = None
        self.needs_fix: Optional[np.ndarray] = None   # bundled features
        self.total_bins: int = 0
        self._device_cache: Dict[str, DeviceData] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, X, config: Config, label=None, weight=None,
                    group=None, init_score=None,
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None,
                    categorical_features=()) -> "BinnedDataset":
        """Build from an in-memory dense matrix (reference
        DatasetLoader::CostructFromSampleData, dataset_loader.cpp:528).

        With `reference` (a validation set aligned to a training set) the
        reference's BinMappers, used features, EFB groups and layout are
        reused, so the rows bin exactly as the training rows would
        (LoadFromFileAlignWithOtherDataset, dataset_loader.cpp:230; the
        JAX package's dataset.py:236-244). `categorical_features` are the
        column indices that bin as categories (ignored with a reference,
        whose mappers decide)."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, nf = X.shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = nf
        ds.feature_names = feature_names or ["Column_%d" % i for i in range(nf)]
        ds.metadata = Metadata(n)
        if label is not None:
            ds.metadata.set_label(label)
        ds.metadata.set_weight(weight)
        ds.metadata.set_query(group)
        ds.metadata.set_init_score(init_score)
        if reference is not None:
            if nf != reference.num_total_features:
                Log.fatal("The validation data has %d features, the "
                          "training data %d" % (nf,
                                                reference.num_total_features))
            ds.bin_mappers = reference.bin_mappers
            ds.used_features = reference.used_features
            ds.inner_of = reference.inner_of
            ds.groups = reference.groups
            ds._finish_layout_like(reference)
            ds.binned = np.zeros((n, len(ds.groups)), dtype=ds._bin_dtype())
            ds._bin_rows(X, ds.binned)
            return ds
        sample = _sample_data(X, config.bin_construct_sample_cnt,
                              config.data_random_seed)
        ds._construct_from_sample(sample, n, config,
                                  set(int(c) for c in categorical_features))
        ds.binned = np.zeros((n, len(ds.groups)), dtype=ds._bin_dtype())
        ds._bin_rows(X, ds.binned)
        return ds

    @classmethod
    def from_arrays(cls, bins: np.ndarray, group_offset, bin_start, bin_end,
                    missing_type, default_bin, most_freq_bin,
                    label=None) -> "BinnedDataset":
        """A dataset from an already binned layout (no BinMappers, so no
        real thresholds): what ``convert.dataset_from_reference`` builds.
        One feature per group (EFB bundles are refused); trees grown on it
        are compared as grower arrays."""
        bins = np.ascontiguousarray(bins)
        if bins.dtype != np.uint8:
            Log.fatal("binned layout must be uint8, got %s" % bins.dtype)
        ds = cls()
        ds.num_data, G = bins.shape
        ds.binned = bins
        ds.group_offset = np.asarray(group_offset, np.int32)
        ds.bin_start = np.asarray(bin_start, np.int32)
        ds.bin_end = np.asarray(bin_end, np.int32)
        F = len(ds.bin_start)
        if F != G:
            Log.fatal("binned layout with %d features in %d groups: EFB "
                      "bundles are not ported yet (ROADMAP.md queue A, item 2: "
                      "binned dataset layouts)" % (F, G))
        ds.num_total_features = F
        ds.used_features = list(range(F))
        ds.inner_of = {f: f for f in range(F)}
        ds.feature_names = ["Column_%d" % i for i in range(F)]
        # EFB orders groups by density, not by feature: recover each
        # feature's group from where its bin range starts
        ds.group_of = (np.searchsorted(ds.group_offset, ds.bin_start,
                                       side="right") - 1).astype(np.int32)
        ds.groups = [[] for _ in range(G)]
        for f, g in enumerate(ds.group_of):
            ds.groups[g].append(f)
        ds.needs_fix = np.zeros(F, dtype=bool)
        ds.missing_type_arr = np.asarray(missing_type, np.int32)
        ds.default_bin = np.asarray(default_bin, np.int32)
        ds.most_freq_bin = np.asarray(most_freq_bin, np.int32)
        ds.is_categorical = np.zeros(F, bool)
        ds.monotone = np.zeros(F, np.int32)
        ds.penalty = np.ones(F, np.float64)
        ds.total_bins = int(ds.bin_end.max()) if F else 0
        ds.metadata = Metadata(ds.num_data)
        if label is not None:
            ds.metadata.set_label(label)
        return ds

    def _construct_from_sample(self, sample: np.ndarray, n: int,
                               config: Config, cat_set=frozenset()) -> None:
        """BinMapper construction + EFB grouping + layout from a row sample
        (the JAX package's BinnedDataset._construct_from_sample, dense
        route)."""
        nf = self.num_total_features
        total_sample = sample.shape[0]
        filter_cnt = max(
            int(config.min_data_in_leaf * total_sample / max(n, 1)), 1)
        forced = _load_forced_bins(config.forcedbins_filename)
        mbbf = list(config.max_bin_by_feature)
        if mbbf and len(mbbf) != nf:
            Log.fatal("max_bin_by_feature has %d entries for %d features"
                      % (len(mbbf), nf))
        self.bin_mappers = []
        for f in range(nf):
            col = sample[:, f]
            nonzero = col[(np.abs(col) > kZeroThreshold) | np.isnan(col)]
            m = BinMapper()
            m.find_bin(
                nonzero, total_sample,
                int(mbbf[f]) if mbbf else config.max_bin,
                config.min_data_in_bin, filter_cnt,
                pre_filter=bool(config.feature_pre_filter),
                bin_type=(BinType.CATEGORICAL if f in cat_set
                          else BinType.NUMERICAL),
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing,
                forced_upper_bounds=forced.get(f, ()))
            self.bin_mappers.append(m)

        self.used_features = [f for f in range(nf)
                              if not self.bin_mappers[f].is_trivial]
        if not self.used_features:
            Log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        self.inner_of = {f: i for i, f in enumerate(self.used_features)}

        inner_mappers = [self.bin_mappers[f] for f in self.used_features]
        n_inner = len(inner_mappers)
        if config.enable_bundle and n_inner > 1:
            nz_masks = [inner_mappers[i].value_to_bin(sample[:, f])
                        != inner_mappers[i].most_freq_bin
                        for i, f in enumerate(self.used_features)]
            order = sorted(range(n_inner),
                           key=lambda i: -int(nz_masks[i].sum()))
            max_conflict = int(total_sample / 10000
                               + config.max_conflict_rate * total_sample)
            self.groups = _greedy_bundle(
                nz_masks, order, [m.num_bin for m in inner_mappers],
                max_conflict)
        else:
            self.groups = [[i] for i in range(n_inner)]
        self._finish_layout(config)

    def _finish_layout(self, config: Config) -> None:
        inner_mappers = [self.bin_mappers[f] for f in self.used_features]
        n_inner = len(inner_mappers)
        G = len(self.groups)
        self.group_of = np.zeros(n_inner, dtype=np.int32)
        self.bin_start = np.zeros(n_inner, dtype=np.int32)
        self.bin_end = np.zeros(n_inner, dtype=np.int32)
        self.needs_fix = np.zeros(n_inner, dtype=bool)
        self.group_offset = np.zeros(G, dtype=np.int32)
        offset = 0
        for gid, feats in enumerate(self.groups):
            self.group_offset[gid] = offset
            multi = len(feats) > 1
            local = 1 if multi else 0    # local bin 0 = group default sentinel
            for i in feats:
                m = inner_mappers[i]
                self.group_of[i] = gid
                self.bin_start[i] = offset + local
                self.bin_end[i] = offset + local + m.num_bin
                self.needs_fix[i] = multi
                local += m.num_bin
            offset += local
        self.total_bins = int(offset)
        self.most_freq_bin = np.array(
            [m.most_freq_bin for m in inner_mappers], dtype=np.int32)
        self.default_bin = np.array(
            [m.default_bin for m in inner_mappers], dtype=np.int32)
        self.missing_type_arr = np.array(
            [m.missing_type for m in inner_mappers], dtype=np.int32)
        self.is_categorical = np.array(
            [m.is_categorical for m in inner_mappers], dtype=bool)
        mono = np.zeros(n_inner, dtype=np.int32)
        for i, f in enumerate(self.used_features):
            if f < len(config.monotone_constraints):
                mono[i] = config.monotone_constraints[f]
        self.monotone = mono
        pen = np.ones(n_inner, dtype=np.float64)
        for i, f in enumerate(self.used_features):
            if f < len(config.feature_contri):
                pen[i] = config.feature_contri[f]
        self.penalty = pen

    def _finish_layout_like(self, ref: "BinnedDataset") -> None:
        for attr in ("group_of", "bin_start", "bin_end", "needs_fix",
                     "group_offset", "total_bins", "most_freq_bin",
                     "default_bin", "missing_type_arr", "is_categorical",
                     "monotone", "penalty"):
            setattr(self, attr, getattr(ref, attr))

    def _bin_dtype(self):
        widths = self.group_widths()
        if len(widths) and int(widths.max()) > 256:
            Log.fatal("a feature group has %d bins; the port stores one byte "
                      "per group (max_bin <= 255; wider groups are ROADMAP.md "
                      "queue A, item 2: binned dataset layouts)"
                      % int(widths.max()))
        return np.uint8

    def _bin_rows(self, X: np.ndarray, out: np.ndarray) -> None:
        """Quantize a row block into group-local bins (writes `out`), one
        group per task on a thread pool: numpy's searchsorted and
        elementwise passes release the interpreter lock, and each group
        writes its own column, so the bins are the serial loop's."""
        n = X.shape[0]

        def one(gid: int) -> None:
            feats = self.groups[gid]
            if len(feats) == 1:
                f = self.used_features[feats[0]]
                out[:, gid] = self.bin_mappers[f].value_to_bin(X[:, f])
                return
            col = np.zeros(n, dtype=np.int64)
            local = 1
            for i in feats:
                f = self.used_features[i]
                m = self.bin_mappers[f]
                b = m.value_to_bin(X[:, f])
                nz = b != m.most_freq_bin
                col[nz] = local + b[nz]
                local += m.num_bin
            out[:, gid] = col

        workers = max(1, min(8, os.cpu_count() or 1, len(self.groups)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for done in [pool.submit(one, g) for g in range(len(self.groups))]:
                done.result()

    def subset(self, rows) -> "BinnedDataset":
        """The rows `rows` (indices into this dataset) with this dataset's
        mappers and layout: the bin matrix's rows, and empty metadata (the
        caller sets the fields of those rows). Binning those rows of the
        raw matrix with this dataset as the reference gives the same bins
        (the JAX package's Dataset.subset, basic.py:344-391, re-bins
        them)."""
        rows = np.asarray(rows, dtype=np.int64)
        ds = BinnedDataset()
        ds.num_data = len(rows)
        ds.num_total_features = self.num_total_features
        ds.feature_names = list(self.feature_names)
        ds.bin_mappers = self.bin_mappers
        ds.used_features = self.used_features
        ds.inner_of = self.inner_of
        ds.groups = self.groups
        ds._finish_layout_like(self)
        ds.binned = np.ascontiguousarray(self.binned[rows])
        ds.metadata = Metadata(ds.num_data)
        return ds

    def add_features_from(self, other: "BinnedDataset") -> None:
        """Append the features of `other` (the same rows) to this dataset
        (reference Dataset::AddFeaturesFrom, src/io/dataset.cpp:1465; the
        JAX package's data/dataset.py:731): its mappers, names, used
        features and groups after this one's, its bin ranges shifted past
        this one's bins, its bin columns after this one's, on the host and
        in every device copy."""
        if self.num_data != other.num_data:
            Log.fatal("Cannot add features from a dataset with a different "
                      "number of rows (%d vs %d)"
                      % (other.num_data, self.num_data))
        if self.binned is None or other.binned is None:
            Log.fatal("Both datasets must be constructed before "
                      "add_features_from")
        nf0, ni0 = self.num_total_features, len(self.used_features)
        G0, tb0 = len(self.groups), self.total_bins
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self.feature_names = (list(self.feature_names)
                              + list(other.feature_names))
        self.used_features = (list(self.used_features)
                              + [nf0 + f for f in other.used_features])
        self.inner_of = {f: i for i, f in enumerate(self.used_features)}
        self.groups = (list(self.groups)
                       + [[ni0 + i for i in g] for g in other.groups])
        self.num_total_features += other.num_total_features
        self.group_of = np.concatenate([self.group_of, other.group_of + G0])
        self.bin_start = np.concatenate([self.bin_start,
                                         other.bin_start + tb0])
        self.bin_end = np.concatenate([self.bin_end, other.bin_end + tb0])
        self.group_offset = np.concatenate([self.group_offset,
                                            other.group_offset + tb0])
        self.total_bins += other.total_bins
        for attr in ("needs_fix", "most_freq_bin", "default_bin",
                     "missing_type_arr", "is_categorical", "monotone",
                     "penalty"):
            setattr(self, attr, np.concatenate([getattr(self, attr),
                                                getattr(other, attr)]))
        self.binned = np.concatenate([self.binned, other.binned], axis=1)
        copies, self._device_cache = self._device_cache, {}
        for key, old in copies.items():
            self.to_device(key, torch.cat(
                [old.bins, other.to_device(key).bins], dim=1))

    # ------------------------------------------------------------------
    @property
    def num_features(self) -> int:
        return len(self.used_features)

    @property
    def has_bundles(self) -> bool:
        return bool(self.needs_fix is not None and self.needs_fix.any())

    def group_widths(self) -> np.ndarray:
        """[G] bins per group (incl. the bundle sentinel)."""
        if self.group_offset is None:
            return np.zeros(0, np.int64)
        return np.diff(np.append(np.asarray(self.group_offset, np.int64),
                                 int(self.total_bins)))

    def fix_info(self):
        """(mf_global, start, end) int32 arrays of the features whose
        histogram omits a bin (EFB-bundled features); empty without
        bundles."""
        idx = np.nonzero(self.needs_fix)[0]
        return ((self.bin_start[idx] + self.most_freq_bin[idx]).astype(np.int32),
                self.bin_start[idx].astype(np.int32),
                self.bin_end[idx].astype(np.int32))

    def to_device(self, device, bins=None) -> DeviceData:
        """The bin matrix and per-feature metadata as tensors on `device`
        (cached per device: one resident copy of the [N, G] matrix);
        `bins`, the matrix already on the device, is used as it is."""
        key = str(torch.device(device))
        hit = self._device_cache.get(key)
        if hit is not None:
            return hit

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)
        if bins is None:
            bins = torch.as_tensor(np.ascontiguousarray(self.binned),
                                   device=device)
        data = DeviceData(
            bins=bins,
            group_offset=t(self.group_offset), group_of=t(self.group_of),
            bin_start=t(self.bin_start), bin_end=t(self.bin_end),
            missing_type=t(self.missing_type_arr),
            default_bin=t(self.default_bin),
            most_freq_bin=t(self.most_freq_bin))
        self._device_cache[key] = data
        return data
