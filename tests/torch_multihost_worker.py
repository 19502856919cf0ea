"""One process of a 2-process gloo group for tests/test_torch_multihost.py:
joins through ``parallel.multihost.initialize``, runs one landmark-sharded
fused EKF step over the world group on the inputs in NPZ, and prints a
RESULT line with checksums. Imports torch and the port only.

    python tests/torch_multihost_worker.py <process_id> <port> <inputs.npz>
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from surikatoko_tpu_torch.geom import camera  # noqa: E402
from surikatoko_tpu_torch.models.monoslam.state import make_params  # noqa: E402
from surikatoko_tpu_torch.parallel import multihost  # noqa: E402
from surikatoko_tpu_torch.parallel.sharded_ekf import (  # noqa: E402
    make_sharded_fused_step)

pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
multihost.initialize(f"localhost:{port}", 2, pid, device="cpu")
inp = {k: torch.as_tensor(v) for k, v in np.load(path).items()}
cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95, (0.01, 0.01),
                             device="cpu")
params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                     process_noise_ang_veloc_std=0.01, device="cpu")
step = make_sharded_fused_step(params, inp["obs"].shape[0])
x2, P2, _, _, info = step(inp["x"], inp["P"], inp["obs"], inp["mask"])
print("RESULT " + json.dumps({
    "pid": pid, "info": multihost.local_slice_info(),
    "multihost": multihost.is_multihost(), "chol_info": int(info),
    "sum_x": float(x2.sum()), "sum_PP": float((P2 * P2).sum()),
    "symmetric": bool(torch.equal(P2, P2.T))}), flush=True)
