"""Count the device events a torch.profiler trace keeps, on one NVIDIA card.

    python3 scripts/trace_drops.py

First runs chip_smoke.py's phases 1-11 and 5 (`chip_smoke._wmd_phases`:
a long process with many traces behind it), then traces a loop of 15
back-to-back launches of #3 (`sddmm_spmm_type1_batch` at paper_5k's
shapes, Q 16, v_r 32, V 100,000, N 5,000, 64 slots a document, inputs of
generator seed 0) three times in each of six ways (a 50 ms wait before
the loop or after its sync, CPU and CUDA activities or CUDA alone) and
once after a profiler warm-up step, printing how many of the 15 launches
each trace holds (raw kineto events and `key_averages`), then the loop's
device time a launch by CUDA events behind a spin kernel.
"""
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    chip_smoke._wmd_phases()
    print(f"[drops] phases 1-11, 5: {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, v_r, V, n, nnz = 16, 32, 100_000, 5000, 64
    k_pad = torch.rand(q, v_r, V + 1, generator=g, device=dev)
    cols = torch.randint(0, V, (n, nnz), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.rand(n, nnz, generator=g, device=dev)
    r = torch.rand(q, v_r, generator=g, device=dev) + 0.1
    u = torch.rand(q, v_r, n, generator=g, device=dev) + 0.1
    k_vm = ops.k_vocab_major(k_pad)

    def loop():
        for _ in range(15):
            ops.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals)

    def kept(prof):
        raw = sum(e.device_type() == DeviceType.CUDA
                  for e in prof.profiler.kineto_results.events())
        avg = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
        return raw, avg

    loop()
    torch.cuda.synchronize()
    for rep in range(3):
        for lead, tail, acts in ((0, 0, "cpu+cuda"), (0.05, 0, "cpu+cuda"),
                                 (0, 0.05, "cpu+cuda"),
                                 (0.05, 0.05, "cpu+cuda"), (0, 0, "cuda"),
                                 (0.05, 0.05, "cuda")):
            act = [ProfilerActivity.CUDA] if acts == "cuda" else [
                ProfilerActivity.CPU, ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            with profile(activities=act) as prof:
                time.sleep(lead)
                loop()
                torch.cuda.synchronize()
                time.sleep(tail)
            print(f"[drops] rep {rep}, wait before {lead} s, after {tail} s, "
                  f"{acts}: (raw, key_averages) device events {kept(prof)} "
                  f"of 15", flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            time.sleep(0.05)
            prof.step()
            loop()
            torch.cuda.synchronize()
            prof.step()
        print(f"[drops] rep {rep}, a warm-up step first: {kept(prof)} of 15 "
              f"(a ProfilerStep annotation adds one)", flush=True)
        torch.cuda.synchronize()
        spin, start, stop = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        spin.record()
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        start.record()
        loop()
        stop.record()
        torch.cuda.synchronize()
        print(f"[drops] rep {rep}, CUDA events behind a spin: "
              f"{start.elapsed_time(stop) / 15:.4f} ms a launch", flush=True)


if __name__ == "__main__":
    main()
