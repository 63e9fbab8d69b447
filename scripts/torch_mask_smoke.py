"""The dense round's mask kernels (pack_rows, feas_idx) and its row-id
upload on one card, in a few minutes: a quicker check than chip_smoke.py
after a change to csrc/dense_mask.cu or to a round's solve stage.

    python3 scripts/torch_mask_smoke.py

From the repository root (it imports chip_smoke and karmada_tpu_torch from
the current directory). It builds the kernels, then:
- holds pack_rows and feas_idx against their plain versions on seeded
  filter rows read through row ids out of order and repeated (10 240 rows
  at 5 120, 5 000 and 77 columns, off a 16-byte boundary, k = 16 and 128)
  and on the dense flagship's own filter output and mask rows, and
  packed_selection on its edge cases (chip_smoke's checks);
- times feas_idx and pack_rows on the dense flagship's call, and a torch
  gather of the same rows, by CUDA events and under torch.profiler, and
  pack_rows on the call one whole-fleet Duplicated round makes;
- runs one round each of the compact flagship, the dense flagship and the
  whole-fleet Duplicated variant with their solve stages under
  torch.cuda.set_sync_debug_mode("error") (chip_smoke.check_solve_syncs);
- times the row-id upload alone on an idle stream, host clock over 1 000
  calls: a pageable `.to(dev)` per array against one `to_device_packed`,
  at config 1's, config 2's and the dense flagship's sizes.
Prints the card's nvidia-smi line first. Needs one CUDA card and nvcc;
a failed check raises.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler, to_device_packed  # noqa: E402

UPLOAD_CALLS = 1000
# the dense round's row-id arrays: config 1's mask rows, config 2's tail
# rows (padded), the dense flagship's two tails (padded) and mask rows
UPLOAD_SIZES = (("config 1", (100,)), ("config 2", (1024,)),
                ("dense flagship", (5120, 3072, 2500)))


def check_and_time(dev):
    clusters, bindings = cs.build_flagship(dense=True)
    sched = ArrayScheduler(clusters, device=dev)
    filt_args, _t, _tails, mask_rows, mk, _ = cs.dense_kernel_inputs(sched, bindings)
    B, C = filt_args[7].shape[0], filt_args[0].shape[0]
    cs.check_mask_kernels(dev, B, C, int(mask_rows.numel()), mk)
    cs.check_selection_edges(np.random.default_rng(5), dev)
    feas = kernels._dense_filter_launch(*filt_args, plugin_bits=sched._plugin_bits)[0]
    for k in (mk, 128):
        cs.compare(f"feas_idx[flagship,{k}]", [kernels._feas_idx_launch(feas, mask_rows, k)],
                   [kernels.feas_idx_plain(feas, mask_rows, k)], ("idx",))
    cs.compare("pack_rows[flagship]", [kernels._pack_rows_launch(feas, mask_rows)],
               [kernels.pack_rows_plain(feas, mask_rows)], ("packed",))
    rows64 = mask_rows.long()
    for name, fn in ((f"feas_idx (k={mk})", lambda: kernels._feas_idx_launch(feas, mask_rows, mk)),
                     ("pack_rows", lambda: kernels._pack_rows_launch(feas, mask_rows)),
                     ("torch gather of the rows", lambda: feas.index_select(0, rows64))):
        ms = cs.cuda_ms(fn, 20)
        dev_ms, events = cs.profiled_calls_ms(fn, 20)
        cs.log(f"{name} at the dense flagship ({int(mask_rows.numel())} of {B} rows x {C}): "
               f"{ms:.4f} ms, device {dev_ms:.4f} ({cs._events_text(events)})")
    idx = kernels._feas_idx_launch(feas, mask_rows, mk)
    bound_ms, bound_by = cs.mask_bound(feas, mask_rows, idx, k=mk)
    cs.log(f"feas_idx's bound at the dense flagship: {bound_ms:.6f} ms ({bound_by})")
    del sched, feas, filt_args
    cs.check_pack_rows_main_call(dev)


def check_syncs(dev):
    for label, dense, whole in (("compact flagship", False, False),
                                ("dense flagship", True, False),
                                ("whole-fleet Duplicated", True, True)):
        clusters, bindings = cs.build_flagship(dense=dense, whole_fleet_dup=whole)
        sched = ArrayScheduler(clusters, device=dev)
        decisions = sched.schedule(bindings)
        cs.check_solve_syncs(label, sched, bindings, decisions)
        del sched, clusters, bindings, decisions


def time_uploads(dev):
    for label, sizes in UPLOAD_SIZES:
        arrays = [np.arange(n, dtype=np.int32) for n in sizes]
        for name, fn in (("pageable .to(dev) per array",
                          lambda: [torch.from_numpy(a).to(dev) for a in arrays]),
                         ("to_device_packed", lambda: to_device_packed(arrays, dev))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(UPLOAD_CALLS):
                fn()
            torch.cuda.synchronize()
            cs.log(f"row-id upload, {label} {list(sizes)}, {name}: "
                   f"{(time.perf_counter() - t0) / UPLOAD_CALLS * 1e3:.4f} ms a call (host)")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mask_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device(cs.DEVICE)
    build.build_all()
    check_and_time(dev)
    check_syncs(dev)
    time_uploads(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
