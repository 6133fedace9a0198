#!/usr/bin/env python3
"""Time ell_spmv_t in each form and lane count at every shape a gradient gives it, on one GPU.

    python3 scripts/spmv_t_forms.py [--out DIR] [--json OUT.json]

ell_spmv_t's C entry picks its form and its lanes a column itself
(`spmv_t_plan` in `csrc/ell_kernels.cu`: the staged form at Kt 17-32, the
lanes form below, each on P = row_lanes(Kt) lanes or on P / 2 as
`spmv_t_half` says; the strided form past 32). To time the others, the
script builds four more copies of the kernel library under DIR (default
`.scratch/spmv_t_forms` in this checkout), each from this tree's `csrc/`
with `spmv_t_form` made to return one form and `spmv_t_half` one answer,
and calls each copy's `ell_spmv_t` in this process on the same inputs as
`scripts/ell_tilings.py --only backward` (the cloth's frame Hessians at
K 7, the 2k beam's two levels, the 19k and 74k fine Hessians, the 21k exp2
beam's fine Hessian and coarse matrix), in both calls: A^T g, and -A^T g
with each row's diagonal slot left out. Every copy's output must be
bit-equal to the package wrapper's (up to a zero's sign) and its kernel the
one of that form and lane count. The script prints the device us of a
launch (torch.profiler) for the wrapper and each copy, writes them to
--json, and exits 1 where a check fails. The strided form, the first one,
is timed at these shapes by `scripts/ell_tilings.py --root` on a tree
that has it.
"""
import argparse
import concurrent.futures
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.config import SolverConfig  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import ell_kernels as ek  # noqa: E402
from fem_simulation_tpu_torch.sim import cloth  # noqa: E402
from fem_simulation_tpu_torch.sim import quasistatic as qs  # noqa: E402
from fem_simulation_tpu_torch.sim.scene import Scene  # noqa: E402

# (form, two entries a lane): the copies built
FORCED = tuple((form, half) for form in (ek.SPMV_T_LANES, ek.SPMV_T_STAGED)
               for half in (False, True))
FORM_RULE = re.compile(r"int spmv_t_form\(int P\) \{.*?\n\}", re.S)
HALF_RULE = re.compile(r"bool spmv_t_half\(int N, int P, int sms\) \{.*?\n\}",
                       re.S)
CALLS = (("plain", False, 1.0), ("diag out", True, -1.0))


def forced_source(text, form, half):
    """ell_kernels.cu's text with spmv_t_form returning `form` and
    spmv_t_half returning `half` (where P >= 2)."""
    text, n = FORM_RULE.subn(
        f"int spmv_t_form(int) {{ return {form}; }}", text)
    text, m = HALF_RULE.subn(
        f"bool spmv_t_half(int, int P, int) {{ return P >= 2 && "
        f"{'true' if half else 'false'}; }}", text)
    if (n, m) != (1, 1):
        raise RuntimeError(f"spmv_t_form / spmv_t_half found {n} / {m} "
                           "times, not once each")
    return text


def forced_library(out, form, half):
    """Load a copy of this tree's kernel library built with forced_source,
    under out/<form><half> by a copy of ops/_cuda.py."""
    tag = f"{ek.SPMV_T_FORMS[form]}{'_half' if half else ''}"
    pkg = os.path.join(out, tag, "fem_simulation_tpu_torch")
    shutil.rmtree(os.path.join(pkg, "csrc"), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "fem_simulation_tpu_torch", "csrc"),
                    os.path.join(pkg, "csrc"))
    os.makedirs(os.path.join(pkg, "ops"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "fem_simulation_tpu_torch", "ops",
                             "_cuda.py"), os.path.join(pkg, "ops"))
    src = os.path.join(pkg, "csrc", "ell_kernels.cu")
    with open(src) as fh:
        text = forced_source(fh.read(), form, half)
    with open(src, "w") as fh:
        fh.write(text)
    spec = importlib.util.spec_from_file_location(
        f"spmv_t_forms_{tag}", os.path.join(pkg, "ops", "_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def systems(dev):
    """[(label, values, mask, tt, diag_slot)] at ell_spmv_t's shapes, seeded
    as scripts/ell_tilings.py --only backward seeds them."""
    out = []
    for label, res in cs.CLOTHS.items():
        sc = cs.cloth_scene(res, dev)
        rng = np.random.default_rng(8)
        p = sc.params
        x = p["x0"] + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(p["x0"].shape)).astype(np.float32)).to(dev)
        vals = cloth._frame_hessian(sc, p, x, cloth._frame_diag(
            sc, p, cloth.init_state(sc), 1.0 / sc.cfg.dt))
        out.append((f"cloth {label}", (vals * p["mask"][..., None, None])
                    .contiguous(), p["mask"], ek.transpose_table(p["nbr"]),
                    p["diag_slot"]))
    for label, beam in cs.BEAMS.items():
        sc = Scene(meshlib.beam(*beam, dx=cs.DX), solver=(
            SolverConfig(n_levels=2) if label == "2k" else SolverConfig()),
            device=dev)
        rng = np.random.default_rng(19)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        fine = qs.assemble_fine(sc, sc.params, x)
        chain = (qs.galerkin_chain(sc, sc.params, fine) if label == "2k"
                 else [fine])
        for li, vals in enumerate(chain):
            op = sc.make_op(li)
            out.append((f"{label} level {li}", vals, op.mask,
                        op.transpose_table(), op.diag_slot))
    sc21 = Scene(meshlib.beam(*cs.EXP_BEAM, dx=cs.DX),
                 solver=SolverConfig(n_levels=2), device=dev)
    rng = np.random.default_rng(19)
    x = sc21.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(sc21.x0.shape)).astype(np.float32)).to(dev)
    for li, vals in enumerate((qs.assemble_fine(sc21, sc21.params, x),
                               cs.exp2_coarse_values(sc21, x))):
        op = sc21.make_op(li)
        out.append((f"21k level {li}", vals, op.mask, op.transpose_table(),
                    op.diag_slot))
    return out


def call_library(lib, vals, mask, tt, g, skip, alpha):
    """One ell_spmv_t launch through `lib`'s C entry into a new tensor."""
    n, k = vals.shape[:2]
    gx = torch.empty_like(g)
    _cuda.check(lib.ell_spmv_t(
        vals.data_ptr(), mask.data_ptr(), tt.data_ptr(),
        None if skip is None else skip.data_ptr(), g.data_ptr(),
        gx.data_ptr(), float(alpha), n, k, int(tt.shape[1]),
        torch.cuda.current_stream().cuda_stream), "ell_spmv_t")
    return gx


def launch_us(fn):
    """(device us of ell_spmv_t_kernel in one call, its kernel names)."""
    for _ in range(3):              # a short trace can lose its last events
        sel = {k: v for k, v in cs.device_ops(fn, 20).items()
               if "ell_spmv_t_kernel" in k}
        if sel:
            return (round(sum(max(1, round(c)) * t for c, t in sel.values()),
                          2), sorted(sel))
    return None, []


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, ".scratch",
                                                  "spmv_t_forms"))
    ap.add_argument("--json", default=None,
                    help="write every time and check here")
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(FORCED) + 1) as pool:
        own = pool.submit(_cuda.load)
        libs = dict(zip(FORCED, pool.map(
            lambda fh: forced_library(args.out, *fh), FORCED)))
        own.result()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failures, rows = [], []
    for label, vals, mask, tt, diag in systems(dev):
        n, k = vals.shape[:2]
        kt = int(tt.shape[1])
        p = ek.lanes(kt)
        g = torch.from_numpy(np.random.default_rng(23).standard_normal(
            (n, 3)).astype(np.float32)).to(dev)
        form, lanes = ek.spmv_t_plan(n, kt, sms)
        for call, with_skip, alpha in CALLS:
            skip = diag if with_skip else None

            def wrapper(skip=skip, alpha=alpha):
                return ek.spmv_t(vals, mask, tt, g, skip, alpha)
            got = wrapper() + 0.0
            us, _ = launch_us(wrapper)
            row = dict(label=label, n=n, k=k, kt=kt, call=call, card=card,
                       plan=[ek.SPMV_T_FORMS[form], lanes], plan_us=us,
                       forced=[])
            parts = []
            for (f, half), lib in libs.items():
                L = p // 2 if half and p >= 2 else p

                def forced(lib=lib, skip=skip, alpha=alpha):
                    return call_library(lib, vals, mask, tt, g, skip, alpha)
                same = torch.equal(forced() + 0.0, got)
                t, names = launch_us(forced)
                right = bool(names) and all(
                    f"ell_spmv_t_kernel<{f}, {L}," in name for name in names)
                if not (same and right):
                    failures.append(f"{label} {call} {ek.SPMV_T_FORMS[f]} "
                                    f"{L} lanes: bit-equal {same}, kernels "
                                    f"{names}")
                row["forced"].append(dict(form=ek.SPMV_T_FORMS[f], lanes=L,
                                          us=t, bit_equal=same))
                parts.append(f"{ek.SPMV_T_FORMS[f]} {L} {t} us (bit-equal "
                             f"{same})")
            rows.append(row)
            print(f"spmv_t_forms {label} N {n} Kt {kt} {call}: the plan's "
                  f"{ek.SPMV_T_FORMS[form]} {lanes} {us} us; "
                  + ", ".join(parts), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=0)
    print(card)
    for f in failures:
        print("FAILED", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
