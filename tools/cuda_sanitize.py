"""Memory and race checks of the port's hand CUDA kernels on the card.

Every entry of chip_smoke.KERNELS launches through one of five kernels
(csrc/merge_rank.cu: pack_view_kernel, merge_path_kernel,
unpermute_planes_kernel, unpermute_counts_kernel; csrc/pair_merge.cu:
pair_merge_kernel).  Two checks drive them, each through
tools/cuda_fuzz.py's kernel rounds (every kernel entry at random ragged
sizes against its plain version):

1. compute-sanitizer, one child process a tool (memcheck, racecheck,
   synccheck, initcheck), each running ``tools/cuda_fuzz.py --trials 0``
   (the kernel rounds alone) at small shapes (SANITIZE_ROWS: several tiles and a
   partial last tile and block) with PYTORCH_NO_CUDA_MEMORY_CACHING=1, so
   that each tensor is an allocation of its own, and the kernel-name
   filter set to the five kernels, so that PyTorch's own kernels are not
   checked.  A finding in a port kernel fails the check; a reported error
   that names no port kernel is counted on a line of its own.  A probe
   runs first (the sanitizer over one PyTorch call on the card): where
   the sanitizer is missing or refuses the card, every tool reports "not
   run" and the reason.
2. Guard bands, which need no tool: each tensor handed to a kernel (the
   inputs, the raw tables and orders the segmented launches read in
   place, and the output and sum slots a caller provides) is copied into
   the middle of a larger buffer whose other bytes hold random junk, the
   round is run twice with different junk, and every result must equal
   the plain version and every guard band keep its bytes.  A read past an
   input's end that changes a result, or a write past an output slot,
   fails.  The segmented launches write caller slots; pack_view_kernel
   and the un-permutes, whose wrappers allocate their outputs, are also
   launched through their C entry points into guarded output views.

    python3 tools/cuda_sanitize.py

prints each tool's error count (or why it did not run) and the guard
bands' result, and exits non-zero when either found a fault or without a
card.  chip_smoke.py phase 11 calls ``sanitize``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

KERNEL_NAMES = ("pack_view_kernel", "merge_path_kernel", "unpermute_planes_kernel",
                "unpermute_counts_kernel", "pair_merge_kernel")
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
SANITIZE_ROWS = 12_000
SANITIZE_ROUNDS = 2
TOOL_TIMEOUT_S = 600
SEED = 7
GUARD = 4096  # junk elements on each side of a guarded tensor
GUARD_ROUNDS = ((8, 12_000), (12, 1 << 20))  # (rounds, largest size)
PROBE = "import torch; x = torch.ones(1000, device='cuda'); print(float(x.sum()))"


def sanitizer() -> str | None:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    path = "/usr/local/cuda/bin/compute-sanitizer"
    return path if os.path.exists(path) else None


def _errors(text: str) -> int | None:
    """The error count of a sanitizer summary line, or None."""
    m = re.search(r"(?:ERROR|RACECHECK|SYNCCHECK|INITCHECK) SUMMARY: (\d+) (?:error|hazard)", text)
    return int(m.group(1)) if m else None


def _blame(text: str) -> tuple[int, int]:
    """(reports naming a port kernel, reports naming none) in a sanitizer
    log: each report opens with '=========' and an error or hazard line."""
    port = other = 0
    for block in re.split(r"\n(?==+ (?:Invalid|Race|Barrier|Uninitialized|Error|Warning))", text):
        if not re.match(r"=+ (?:Invalid|Race|Barrier|Uninitialized|Error|Warning)", block):
            continue
        if any(k in block for k in KERNEL_NAMES):
            port += 1
        else:
            other += 1
    return port, other


def probe(tool_path: str) -> str | None:
    """None when the sanitizer runs a PyTorch call on the card cleanly,
    else why it cannot."""
    r = subprocess.run([tool_path, "--tool", "memcheck", sys.executable, "-c", PROBE],
                       capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
    out = r.stdout + r.stderr
    if r.returncode == 0 and _errors(out) == 0:
        return None
    first = [ln.strip("= ").strip() for ln in out.splitlines() if "Error" in ln or "error" in ln]
    return f"rc {r.returncode}, {first[0] if first else out.strip()[-200:]}"


def run_tool(tool_path: str, tool: str, report) -> dict:
    cmd = [tool_path, "--tool", tool, "--print-limit", "10000"]
    for name in KERNEL_NAMES:
        cmd += ["--kernel-name", f"kns={name}"]
    cmd += [sys.executable, os.path.join(REPO, "tools", "cuda_fuzz.py"), "--trials", "0",
            "--rounds", str(SANITIZE_ROUNDS), "--kernel-rows", str(SANITIZE_ROWS),
            "--seed", str(SEED)]
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=TOOL_TIMEOUT_S, env=env,
                       cwd=REPO)
    out = r.stdout + r.stderr
    total = _errors(out)
    port, other = _blame(out)
    res = {"tool": tool, "rc": r.returncode, "errors": total, "port": port, "other": other,
           "seconds": time.perf_counter() - t0,
           "target_ok": "FUZZ PASSED" in out}
    report(f"{tool}: {total} errors ({port} in the port's kernels, {other} elsewhere), "
           f"target {'passed' if res['target_ok'] else 'FAILED'}, rc {r.returncode}, "
           f"{res['seconds']:.1f} s")
    if total is None or port or not res["target_ok"]:
        report(f"--- {tool} log (tail) ---\n{out[-3000:]}")
    return res


class Guards:
    """Tensors copied between guard bands of random junk; ``check`` lists
    the bands whose bytes changed."""

    def __init__(self, rng):
        self.rng = rng
        self.held = []

    def place(self, t):
        import torch

        n = t.numel()
        bits = self.rng.integers(-(2**31), 2**31, 2 * GUARD + n, dtype=np.int64)
        buf = torch.from_numpy(bits.astype(np.int64 if t.dtype == torch.int64 else np.int32))
        buf = buf.to(t.device)
        buf[GUARD:GUARD + n] = t.reshape(-1)
        self.held.append((buf, n, buf[:GUARD].clone(), buf[GUARD + n:].clone()))
        return buf[GUARD:GUARD + n].view(t.shape)

    def check(self) -> list[str]:
        import torch

        bad = []
        for i, (buf, n, lo, hi) in enumerate(self.held):
            if not torch.equal(buf[:GUARD], lo):
                bad.append(f"tensor {i} ({n} elements): the band before it changed")
            if not torch.equal(buf[GUARD + n:], hi):
                bad.append(f"tensor {i} ({n} elements): the band after it changed")
        return bad


def guarded_outputs(dev, rng, cap: int, guards: Guards) -> str:
    """pack_view_kernel and the two un-permute kernels writing into output
    views between guard bands: their C entry points called as their
    wrappers call them, with a guarded view where the wrapper allocates
    the output; each output must equal the plain version."""
    import torch

    from sequila_tpu_torch.ops.cuda import _lib
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from tools.cuda_fuzz import FuzzFailure, draw_size

    lib = _lib.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rand(*shape, lo=-(2**31), hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)).to(dev)

    def out(*shape):
        return guards.place(torch.full(shape, -1, dtype=torch.int32, device=dev))

    n, nkeys = draw_size(rng, cap), int(rng.integers(1, 30))
    k, v, c = (guards.place(t) for t in (rand(n, lo=0, hi=nkeys), rand(n), rand(nkeys)))
    packed = out(n)
    _lib.check(lib.seq_pack_view(k.data_ptr(), v.data_ptr(), c.data_ptr(), nkeys, mc.BUILD_PAD,
                                 packed.data_ptr(), n, stream), "pack_view")
    m = draw_size(rng, cap)
    inv = [guards.place(torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev))
           for _ in range(2)]
    r2, r4 = guards.place(rand(2, m, lo=0, hi=2**30)), guards.place(rand(4, m, lo=0))
    counts, planes = out(m), out(4, m)
    _lib.check(lib.seq_unpermute_counts(r2.data_ptr(), inv[0].data_ptr(), inv[1].data_ptr(),
                                        counts.data_ptr(), m, stream), "unpermute_counts")
    _lib.check(lib.seq_unpermute_planes(r4.data_ptr(), inv[0].data_ptr(), inv[1].data_ptr(),
                                        planes.data_ptr(), m, stream), "unpermute_ranks")
    for name, got, want in (
            ("pack_view", packed, mc.pack_view_plain(k, v, c, mc.BUILD_PAD)),
            ("unpermute_counts", counts, mc.unpermute_counts_plain(r2, *inv)),
            ("unpermute_ranks", planes, mc.unpermute_ranks_plain(r4, *inv))):
        if not torch.equal(got, want):
            raise FuzzFailure(f"{name} into a guarded output differs from the plain version")
    return f"pack_view {n} and the un-permutes {m} into guarded outputs"


def guard_rounds(dev, report) -> dict:
    """tools/cuda_fuzz.py's kernel rounds with every kernel tensor between
    guard bands, each round twice with different junk."""
    import torch

    from tools.cuda_fuzz import FuzzFailure, kernel_round

    err, rounds, faults = {}, 0, []
    for count, cap in GUARD_ROUNDS:
        for r in range(count):
            shapes = "failed"
            for fill in (0, 1):
                guards = Guards(np.random.default_rng([SEED, cap, r, fill]))
                try:
                    rng = np.random.default_rng([SEED, cap, r])
                    shapes = kernel_round(rng, dev, cap, err, place=guards.place)
                    if dev.type == "cuda":
                        shapes += "; " + guarded_outputs(dev, rng, cap, guards)
                except FuzzFailure as e:
                    faults.append(f"round {r} (sizes up to {cap}, junk {fill}): {e}")
                    continue
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                faults += [f"round {r} (sizes up to {cap}, junk {fill}): {b}"
                           for b in guards.check()]
                rounds += 1
            report(f"guard bands, round {r}, sizes up to {cap}: {shapes}")
    return {"rounds": rounds, "faults": faults}


def sanitize(report=print) -> dict:
    """Both checks; returns {"tools": {tool: result or reason}, "guards":
    ..., "ok": bool}."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"tools": {}}
    tool_path = sanitizer()
    why = "compute-sanitizer not found" if tool_path is None else probe(tool_path)
    if tool_path is not None:
        version = subprocess.run([tool_path, "--version"], capture_output=True, text=True)
        report(f"{tool_path}: {version.stdout.strip().splitlines()[-1]}")
    ok = True
    for tool in TOOLS:
        if why is not None:
            res["tools"][tool] = f"not run: {why}"
            report(f"{tool}: not run: {why}")
            continue
        r = run_tool(tool_path, tool, report)
        res["tools"][tool] = r
        if tool != "initcheck":  # initcheck is reported; its findings are read by hand
            ok &= r["errors"] is not None and r["port"] == 0 and r["target_ok"]
    t0 = time.perf_counter()
    res["guards"] = guard_rounds(dev, report)
    for f in res["guards"]["faults"]:
        report(f"guard bands: FAULT {f}")
    report(f"guard bands: {res['guards']['rounds']} rounds, "
           f"{len(res['guards']['faults'])} faults, {time.perf_counter() - t0:.1f} s")
    res["ok"] = ok and not res["guards"]["faults"]
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: the checks need a CUDA device",
              file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    res = sanitize(lambda s: print(s, flush=True))
    print("SANITIZE " + ("PASSED" if res["ok"] else "FAILED"), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
