"""What each part of the gather-bag kernel's design buys, on one CUDA card.

    python3 scripts/torch_bag_variants.py [--parent PATH]

At ``chip_smoke.py`` phase 7's shape (the OGBN-Arxiv-shaped padded CSR
of a seeded power-law graph: S 169,343 x K 23, D 128, f32 and bf16) it
times, by CUDA-graph replay with the L2 overwritten before each call and
by eager events beside, the kernel of ``csrc/gather_runahead.cu`` and
variants of it that this script derives from that source by text
substitution.  The variants are defined on one version of that source
only, the one whose SHA-256 is ``SOURCE_SHA256``: on any other the
script refuses to run, since a substitution that still applies could
then measure something other than its name says.  Re-derive the
variants, and the hash, for a new version of the kernel.

* ``dedup`` is the kernel without its two accumulation changes (every
  entry added, four passes of 32 chunks issued whatever the row's width),
  and ``dedup-46`` the same with rings of 46 rows a warp, not one batch
  (about the old kernel's warps per SM);
* ``passes`` adds the passes sized to the row; ``kernel`` adds the skip
  of repeated zero-weight entries: the kernel as it is;
* ``ca`` copies rows through L1 (``cp.async.ca``) instead of past it;
* the kernel on the bag with its pad entries, and then its hub's, spread
  over 251 rows each (same fetches, no hot row);
* ``no-accumulation`` and ``no-copies`` drop the accumulation loop or the
  row copies (outputs not checked): what the rest of the kernel costs.

``--parent PATH`` adds the kernel source at PATH under the name
``parent`` (the same ``gather_bag_launch`` interface, no warps-per-SM
query), e.g. the source before the bag's redesign: ``git show
561434c:src/repro_torch/kernels/gather_runahead/csrc/gather_runahead.cu``.
Every checked output must equal ``ref.gather_bag_ordered_ref`` bit for
bit.  Prints fetches, warps per SM, ``embedding_bag`` and the bytes
bound.  Builds into ``build/dev/`` beside the checkout's other builds.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gather_runahead import ref  # noqa: E402

DEV = ROOT / "build" / "dev"
# the kernel source the variants below are written against
SOURCE_SHA256 = "567b80387766ec42341fc8ba76b2a9f5689130af6484135552377286a8efb0d4"
COPY = "cp_async16(dst + c * 16, src + c * 16);"
REPEAT = "lane > 0 && my_w == 0.f && prev_w == 0.f && my_slot == prev_slot"
PASSES = ("  if (chunks <= 32)\n", "  if (chunks <= 64)\n")
DEDUP = [(REPEAT, "false")] + [(p, "  if (false)\n") for p in PASSES]
RING = "const int ring = K < 32 ? (K > 1 ? K : 1) : 32;"
VARIANTS = {   # name: [(old, new), ...] applied to the kernel's source
    "kernel": [],
    "passes": [(REPEAT, "false")],
    "dedup": DEDUP,
    "dedup-46": DEDUP + [(RING, "const int ring = 46;")],
    "ca": [("cp.async.cg.shared", "cp.async.ca.shared")],
    "no-accumulation": [
        ("for (unsigned m = __ballot_sync(kFull, lane < kn && !repeat); m;",
         "for (unsigned m = 0u & __ballot_sync(kFull, !repeat); m;")],
    "no-copies": [("        " + COPY + "\n      if (++slot == ring)",
                   "        ;\n      if (++slot == ring)")],
}
LAUNCH_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def derive(name: str, source: str) -> Path:
    """The variant's source, written to build/dev/."""
    for old, new in VARIANTS[name]:
        if old not in source:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               f"kernel's source")
        source = source.replace(old, new)
    path = DEV / f"bag_{name}.cu"
    path.write_text(source, encoding="utf-8")
    return path


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together."""
    DEV.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(DEV / f"bag_{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(DEV / f"bag_{name}.so"))
        lib.gather_bag_launch.argtypes = LAUNCH_ARGS
        lib.gather_bag_launch.restype = ctypes.c_int
        if name != "parent":
            lib.gather_bag_warps_per_sm.argtypes = [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bag_variants: no CUDA device", file=sys.stderr)
        return 1
    path = _build.SOURCES["gather_runahead"]
    source = path.read_text(encoding="utf-8")
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != SOURCE_SHA256:
        print(f"torch_bag_variants: the kernel source (sha256 {digest}) is "
              f"not the one its variants are written against "
              f"({SOURCE_SHA256}); re-derive them", file=sys.stderr)
        return 1
    DEV.mkdir(parents=True, exist_ok=True)
    sources = {name: derive(name, source) for name in VARIANTS}
    if args.parent is not None:
        sources["parent"] = args.parent
    libs = build(sources)

    inp = cs.runahead_inputs()
    idx, w = inp["bag_idx"], inp["bag_w"]
    s, k = idx.shape
    host = idx.cpu().numpy()
    values, counts = np.unique(host[host != 0], return_counts=True)
    hub = int(values[counts.argmax()])
    spread = (1 + np.arange(s) % 251)[:, None]
    no_pad = np.where(host == 0, spread, host)
    no_hot = np.where(host == hub, (hub + spread) % cs.ARXIV_NODES, no_pad)
    bags = {"bag": idx}
    for name, a in (("pads spread", no_pad), ("pads, hub spread", no_hot)):
        bags[name] = torch.from_numpy(a.astype(np.int32)).cuda()
    card = cs.card_line()
    print(f"S {s} K {k}: row fetches {cs.bag_fetches(host)} (padded "
          f"{s * k}); pad share {(host == 0).mean():.4f}; hub row {hub} in "
          f"{int((host == hub).any(1).sum())} rows; {card}", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")

    # (variant, bag) in the order of the design's steps
    runs = [("parent", "bag"), ("dedup-46", "bag"), ("dedup", "bag"),
            ("passes", "bag"), ("kernel", "bag"), ("ca", "bag"),
            ("kernel", "pads spread"), ("kernel", "pads, hub spread"),
            ("no-accumulation", "bag"), ("no-copies", "bag")]
    bad = []
    for dtype, table in inp["tables"].items():
        dname = str(dtype).split(".")[-1]
        code = 0 if dtype == torch.float32 else 1
        d, elt = table.shape[1], table.element_size()
        n_bytes = (torch.unique(idx).numel() * d * elt + s * k * 4 * 2
                   + s * d * elt)
        idx64, w_lib = idx.long(), w.to(dtype)

        def library():
            return torch.nn.functional.embedding_bag(
                idx64, table, per_sample_weights=w_lib, mode="sum")

        print(f"{dname}: bound_ms={n_bytes / cs.MEM_BYTES_PER_S * 1e3:.4f} "
              f"({n_bytes} bytes); embedding_bag {cs.graph_ms(library, flush):.4f}"
              f" ms (graph replay; eager {cs.time_ms(library, flush):.4f})",
              flush=True)
        for name, bag_name in runs:
            if name not in libs:
                continue
            bag = bags[bag_name]
            want = ref.gather_bag_ordered_ref(table, bag, w)
            for depth in (1, 2, 4, 8):
                def launch():
                    out = torch.empty(s, d, dtype=dtype, device="cuda")
                    stream = torch.cuda.current_stream().cuda_stream
                    common = (code, table.data_ptr(), bag.data_ptr(),
                              w.data_ptr(), out.data_ptr(), s, k, d, depth)
                    err = libs[name].gather_bag_launch(*common, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                    return out
                same = cs.bit_equal(launch(), want)
                if not same and not name.startswith("no-"):
                    bad.append(f"{dname} {name} {bag_name} depth {depth}")
                if name == "parent":
                    warps = "n/a"
                else:
                    n = ctypes.c_int(0)
                    libs[name].gather_bag_warps_per_sm(
                        code, k, d, depth, ctypes.addressof(n))
                    warps = n.value
                print(f"{dname} {name:15s} {bag_name:16s} "
                      f"depth {depth}: {cs.graph_ms(launch, flush):.4f} ms "
                      f"(graph replay; eager "
                      f"{cs.time_ms(launch, flush):.4f}); warps per SM "
                      f"{warps}; bit-identical {same}", flush=True)
    print(card)
    if bad:
        print(f"not bit-identical to the ordered plain version: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
