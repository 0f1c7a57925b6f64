"""The persistent payload: one int32 matrix that carries every per-row value
of the persistent-payload grower.

The port of the payload half of lightgbm_tpu/ops/grow_persist.py
(``persist_pack_ok``, ``_payload_plan``, ``payload_weight_row``,
``_payload_geometry``, ``_pack_payload``, ``build_assets``:135-391). The
layout is the JAX package's, word for word, so that ``pay0`` is equal bit
for bit (the tests compare the two):

  rows 0 .. nbw-1   bin slots: a byte per group, or two 4-bit nibbles per
                    byte for groups of at most 16 bins (``_payload_plan``)
  row  nbw          label      (f32 bits)
  row  nbw + 1      row id     (n on the padding lanes)
  row  nbw + 2      gradient   (f32 bits, rewritten every iteration)
  row  nbw + 3      hessian    (f32 bits)
  rows nbw + 4 ..   score      (f32 bits; moves with its row): one row
                    per tree of an iteration, K (num_scores), class k at
                    nbw + 4 + k
  [rows nbw + 4 + K ..  snapshot, K > 1 only: the K score rows as they
                    were at the iteration's start, which every class
                    tree's gradient reads (lightgbm_tpu/ops/
                    grow_persist.py:836-837)]
  [row payload_weight_row  sample weight, when the dataset has weights]
  rows .. WPA       zero padding to a multiple of 8

For multiclass the label row holds the class index as f32.

Lanes are rows of the data: lane ``i < n`` holds one training row, lanes
``n .. NP`` are padding. The geometry arithmetic (``C``, ``CR``, ``NP``,
``WPA``) is kept as it is, so the port's payload is the JAX package's; the
padding costs the card nothing but memory.

The JAX package keeps the payload as uint32; torch has few uint32
operations, so the port stores the same bits as int32 (read f32 rows with
``.view(torch.float32)``; mask after every right shift). Only the
single-shard, f32-score layout is ported: sharding is ROADMAP.md queue A,
item 11, and the widened f64 score rows (``score64``) belong to the JAX
package's XLA emulation mode, which the port does not have.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..data.dataset import nibble_slot_partition
from ..utils.log import LightGBMError


class PersistPackError(ValueError):
    """A dataset geometry the payload pack plan cannot express."""


def persist_pack_ok(dataset):
    """(ok, reason): can the payload pack plan express this dataset? Any
    dense binned layout with at most 256 bins per group can."""
    if dataset.binned is None:
        return False, "the dataset has no dense bin matrix"
    widths = dataset.group_widths()
    if len(widths) and int(widths.max()) > 256:
        return False, ("group width %d > 256 bins exceeds the payload "
                       "byte-slot plan" % int(widths.max()))
    return True, ""


def _payload_plan(widths):
    """(plan, nbw): plan[g] = (word_row, bit_shift, value_mask) of group g.
    Wide groups take a byte slot each, in group order; groups of at most 16
    bins share byte slots in nibble pairs; four byte slots per 32-bit word.
    nbw is the number of bin words."""
    G = len(widths)
    wide, pairs, leftover = nibble_slot_partition(widths)
    plan = [None] * G
    slot = 0
    for g in wide:
        plan[g] = (slot // 4, (slot % 4) * 8, 255)
        slot += 1
    for a, b in pairs:
        w, sh = slot // 4, (slot % 4) * 8
        plan[a] = (w, sh, 15)
        plan[b] = (w, sh + 4, 15)
        slot += 1
    if leftover is not None:
        plan[leftover] = (slot // 4, (slot % 4) * 8, 15)
        slot += 1
    nbw = max((slot + 3) // 4, 1)
    return tuple(plan), nbw


def payload_weight_row(nbw: int, num_scores: int,
                       score64: bool = False) -> int:
    """Row of the optional weight row, which is also the number of live
    rows without it (bins | label | rid | grad | hess | score*K [|
    snapshot*K])."""
    K = num_scores
    SR = 2 if score64 else 1
    return nbw + 4 + SR * K + (SR * K if K > 1 else 0)


def _payload_geometry(n: int, nbw: int, C: int, CR: int,
                      num_scores: int = 1, has_weight: bool = False,
                      score64: bool = False):
    """(WPA, C, NP): padded row count, chunk lanes and payload lanes, by the
    JAX package's arithmetic (grow_persist.py:244-271). C and CR are the
    TPU kernels' chunk sizes; the port keeps them only so that NP, and so
    the payload, is the same."""
    K = num_scores
    WP = payload_weight_row(nbw, K, score64) + (1 if has_weight else 0)
    WPA = ((WP + 7) // 8) * 8
    if C <= 0:
        C = 16384 if WPA <= 56 else 8192
    NP = max(((n + 127) // 128 + 2) * 128 + C + 256,
             ((n + CR - 1) // CR) * CR)
    return WPA, C, NP


def _pack_payload(binned: np.ndarray, labels: np.ndarray, n: int,
                  WPA: int, NP: int, nbw: int, rid_offset: int,
                  rid_sentinel: int, plan, weights=None,
                  weight_row: int = 0) -> np.ndarray:
    """The [WPA, NP] uint32 payload of one shard, packed per `plan`."""
    pay = np.zeros((WPA, NP), np.uint32)
    col = binned.astype(np.uint32)
    for g, (w, sh, mk) in enumerate(plan):
        np.bitwise_or(pay[w, :n],
                      (col[:, g] & np.uint32(mk)) << np.uint32(sh),
                      out=pay[w, :n])
    pay[nbw, :n] = np.ascontiguousarray(
        labels.astype(np.float32)).view(np.uint32)
    pay[nbw + 1, :n] = rid_offset + np.arange(n, dtype=np.uint32)
    pay[nbw + 1, n:] = rid_sentinel
    if weights is not None:
        pay[weight_row, :n] = np.ascontiguousarray(
            weights.astype(np.float32)).view(np.uint32)
    return pay


class PersistAssets(NamedTuple):
    """The payload and the per-feature decode scalars, on the host."""
    pay0: np.ndarray       # [WPA, NP] uint32
    dec_word: np.ndarray   # [F] i32 payload word row of each feature's slot
    dec_shift: np.ndarray  # [F] i32
    dec_mask: np.ndarray   # [F] i32
    nb: np.ndarray         # [F] i32 bin count
    mt: np.ndarray         # [F] i32 missing type
    db: np.ndarray         # [F] i32 default bin
    ls: np.ndarray         # [F] i32 group-local bin range start
    le: np.ndarray         # [F] i32 range end
    mf: np.ndarray         # [F] i32 most frequent (feature-local) bin
    geometry: tuple        # (WPA, NP, G, plan, nbw, n, C, CR, K, has_w,
    #                      #  score64)
    efb: tuple             # (group_of, ls, nb, mf, needs_fix, bundled, mt,
    #                      #  db) numpy


def build_assets(dataset, labels: np.ndarray, C: int = 0, CR: int = 16384,
                 num_shards: int = 1, num_scores: int = 1,
                 use_weight_row: bool = True,
                 score64: bool = False) -> PersistAssets:
    """The payload of a BinnedDataset (once per dataset), with the JAX
    package's signature; the sample weights ride as one payload row."""
    if num_shards != 1:
        raise LightGBMError("a payload cut into %d shards is not ported yet "
                            "(ROADMAP.md queue A, item 11: distributed "
                            "training)" % num_shards)
    if score64:
        raise LightGBMError("score64 (the f64 score rows of the JAX "
                            "package's widened XLA emulation) is not "
                            "ported: the port keeps f32 score rows")
    if num_scores < 1:
        raise LightGBMError("a payload needs at least one score row, got "
                            "num_scores=%d" % num_scores)
    n = int(dataset.num_data)
    ok, why = persist_pack_ok(dataset)
    if not ok:
        raise PersistPackError("persist payload pack plan unavailable: "
                               + why)
    binned = dataset.binned
    G = binned.shape[1]
    plan, nbw = _payload_plan(dataset.group_widths())
    weight = dataset.metadata.weight if use_weight_row else None
    has_w = weight is not None
    WPA, C, NP = _payload_geometry(n, nbw, C, CR, num_scores, has_w)
    weight_row = payload_weight_row(nbw, num_scores)
    pay = _pack_payload(binned, np.asarray(labels), n, WPA, NP, nbw,
                        rid_offset=0, rid_sentinel=n, plan=plan,
                        weights=None if weight is None else
                        np.asarray(weight),
                        weight_row=weight_row)
    group_of = dataset.group_of.astype(np.int32)
    ls = (dataset.bin_start - dataset.group_offset[group_of]).astype(np.int32)
    nb = (dataset.bin_end - dataset.bin_start).astype(np.int32)
    mf = dataset.most_freq_bin.astype(np.int32)
    mt = dataset.missing_type_arr.astype(np.int32)
    db = dataset.default_bin.astype(np.int32)
    needs_fix = np.asarray(dataset.needs_fix, dtype=bool)
    bundled = bool(G != len(nb) or needs_fix.any() or np.any(ls != 0))
    plan_arr = np.asarray(plan, np.int32)
    return PersistAssets(
        pay0=pay,
        dec_word=plan_arr[group_of, 0], dec_shift=plan_arr[group_of, 1],
        dec_mask=plan_arr[group_of, 2],
        nb=nb, mt=mt, db=db, ls=ls, le=(ls + nb).astype(np.int32), mf=mf,
        geometry=(WPA, NP, G, tuple(plan), nbw, n, C, CR, num_scores,
                  has_w, False),
        efb=(group_of, ls, nb, mf, needs_fix, bundled, mt, db))
