"""Launch counts kept on the device.

A wrapper's Python counter (``fn.launches``) counts the calls that queue
its kernel. Under a CUDA graph that counts captures, not replays, and the
persistent grower's fixed trip count queues steps that do nothing once its
tree has stopped growing. So each kernel on that grower's path also keeps a
count in device memory: its first thread adds one when the launch does its
work (a kernel returns at once, uncounted, when the grower's done flag is
set). The plain versions keep the same counts in a CPU array, so the tests
hold them too.

:func:`counts` is the int64 array of one device (slots :data:`SLOTS`),
allocated on first use; the persistent grower allocates it before it
captures a graph. :func:`ptr` is a slot's address for a C launcher.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

SLOTS = ("root_hist", "split_pass", "seg_hist", "scan_pair", "scan_blocks",
         "consolidate", "grow_root", "grow_pick", "grow_commit",
         "grow_planes", "grow_assemble", "apply_scores", "renew_leaf",
         "lambdarank_grad", "xendcg_grad", "scan_pair_knob", "cat_scan",
         "bag_apply", "goss_select", "bag_rows", "apply_scores_avg",
         "leaf_sums")
_INDEX = {name: i for i, name in enumerate(SLOTS)}
_COUNTS: Dict[str, torch.Tensor] = {}


def counts(device) -> torch.Tensor:
    """The [len(SLOTS)] int64 counts of `device`, allocated on first use."""
    device = torch.device(device)
    key = str(device if device.index is not None or device.type == "cpu"
              else torch.device(device.type, torch.cuda.current_device()))
    t = _COUNTS.get(key)
    if t is None:
        t = torch.zeros(len(SLOTS), dtype=torch.int64, device=device)
        _COUNTS[key] = t
    return t


def ptr(device, name: str) -> ctypes.c_void_p:
    """The device address of slot `name`."""
    t = counts(device)
    return ctypes.c_void_p(t.data_ptr() + _INDEX[name] * t.element_size())


def bump(device, name: str) -> None:
    """One more for `name` (the plain versions, on the CPU)."""
    counts(device)[_INDEX[name]] += 1


def read(device) -> Dict[str, int]:
    """The counts of `device` by slot name (reads the device)."""
    return dict(zip(SLOTS, counts(device).tolist()))


def reset(device) -> None:
    counts(device).zero_()
