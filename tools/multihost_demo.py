"""2-process CPU demo of multi-host block-parallel xz decode.

Launch: python tools/multihost_demo.py <proc_id> <num_procs>
(each process decodes its block subset; all assert the full result).
The processes force the CPU backend: several JAX processes must never
open one GPU, since each reserves most of a card's memory.
"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
proc, nproc = int(sys.argv[1]), int(sys.argv[2])
import jax
jax.distributed.initialize(
    coordinator_address="127.0.0.1:9711", num_processes=nproc, process_id=proc
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import lzma_rs_tpu
from lzma_rs_tpu import corpus
from lzma_rs_tpu.parallel import multihost

data = corpus.golden("foo.txt")
c = lzma_rs_tpu.xz_compress(data, block_size=1 << 14, check_method=4)
out = multihost.xz_decode_multihost(c)
assert out == data, f"proc {proc}: mismatch"
# again with tiny waves so several overlapped gathers actually happen
flags, spans, total = multihost.scan_blocks(c)
owner = multihost.assign_blocks(spans, nproc)
hw, sizes = multihost.plan_waves(spans, owner, nproc, wave_bytes=32768)
multihost.WAVE_BYTES = 32768
out2 = multihost.xz_decode_multihost(c)
assert out2 == data, f"proc {proc}: wave mismatch"
print(
    f"proc {proc}/{nproc}: OK ({len(out)} bytes, bit-exact; "
    f"{len(sizes)} waves pipelined)", flush=True,
)
