"""Worker for the two-process multi-host test (spawned by test_parallel).

Each process joins a real jax.distributed cluster (CPU backend, localhost
coordinator), computes PIV on its own frame segment, and participates in the
barrier + manifest protocol of process_segments_multihost.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    frames_npy = sys.argv[4]
    outdir = sys.argv[5]

    from pyorc_tpu.parallel import distributed as dist

    got_pid, got_nproc = dist.init_distributed(f"localhost:{port}", nproc, pid)
    assert (got_pid, got_nproc) == (pid, nproc), (got_pid, got_nproc)

    frames = np.load(frames_npy)
    from pyorc_tpu.ops import piv, windows

    h, w = frames.shape[-2:]
    n_rows, n_cols = windows.get_field_shape((h, w), (32, 32), (16, 16))

    def run_segment(start, end, out_path):
        u, v, cmax, s2n = (
            np.asarray(a)
            for a in piv.piv_pairs(frames[start:end], (h, w), (32, 32), (16, 16), n_rows, n_cols)
        )
        with open(out_path, "wb") as f:
            np.savez(f, u=u, v=v, cmax=cmax, s2n=s2n)

    out = dist.process_segments_multihost(frames.shape[0], run_segment, outdir)
    print(f"worker {pid} done: {out}", flush=True)


if __name__ == "__main__":
    main()
