"""Multi-host (2-process) jax.distributed CPU cluster test.

The reference's scale-out is a shared-memory thread pool; the device
equivalent must also work across HOSTS (jax.distributed + a global mesh +
shard_map collectives over DCN). This spawns two fresh processes, each
owning 4 virtual CPU devices, forms a global 8-device mesh, runs the
production sharded compress path, and checks the assembled frame on process
0 is byte-identical to the single-process result.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stenos_tpu.parallel.api import _sharded_encode_gather
from stenos_tpu.engine_jax import frame_header_bytes

bpp = 4
sb = 256 * bpp * 2
n_sb = 8
rng = np.random.default_rng(1)
data = np.sort(
    rng.integers(0, 1 << 30, (n_sb * sb) // bpp, dtype=np.int64)
    .astype(np.uint32)).view(np.uint8).reshape(n_sb, sb)

mesh = Mesh(np.asarray(jax.devices()), ("chunks",))
sharding = NamedSharding(mesh, P("chunks"))


def cb(index):
    return data[index]


garr = jax.make_array_from_callback(data.shape, sharding, cb)
rows, sizes, offs = _sharded_encode_gather(mesh, garr, bpp, 2, "chunks")
# outputs are fully replicated; every process can read them
rows_h = np.asarray(rows)
sizes_h = np.asarray(sizes)
offs_h = np.asarray(offs)
if pid == 0:
    hdr = frame_header_bytes(n_sb * sb, sb, bpp, 1)
    frame = bytearray(bytes(hdr))
    for i in range(n_sb):
        frame += bytes(rows_h[i][: sizes_h[i]])
    assert offs_h[0] == 8
    with open(out_path, "wb") as f:
        f.write(bytes(frame))
print(f"worker {pid} done", flush=True)
"""


@pytest.mark.skipif(os.environ.get("STENOS_SKIP_DISTRIBUTED") == "1",
                    reason="explicitly disabled")
def test_two_process_distributed_compress(tmp_path):
    # ephemeral port: concurrent runs (parallel CI jobs on one runner) must
    # not collide on a hardcoded coordinator port
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "frame.bin"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid), str(port),
                          str(out)], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        so, _ = p.communicate(timeout=600)
        logs.append(so.decode(errors="replace"))
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-3000:]
    frame = out.read_bytes()

    # single-process reference: the plain frame layer on the same data
    from stenos_tpu import frame as fr

    bpp = 4
    sb = 256 * bpp * 2
    n_sb = 8
    rng = np.random.default_rng(1)
    data = np.sort(
        rng.integers(0, 1 << 30, (n_sb * sb) // bpp, dtype=np.int64)
        .astype(np.uint32)).view(np.uint8).reshape(-1)
    back = fr.decompress(frame, bpp)
    assert bytes(memoryview(np.asarray(back))) == data.tobytes()
