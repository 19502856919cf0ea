"""Two real processes joined by the port's ``parallel/multihost.initialize``
(gloo on the CPU, a localhost TCP store) run one landmark-sharded fused EKF
step over the world group (tests/torch_multihost_worker.py, torch and the
port only). Both get the same checksums, and these match the JAX
single-process fused step on the same inputs (test_multihost.py's case)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from surikatoko_tpu.geom import camera
from surikatoko_tpu.models.monoslam import make_params, measure
from surikatoko_tpu.models.monoslam.fused_step import (
    fused_update_health_predict)
from surikatoko_tpu_torch.parallel.launch import free_port

from test_parallel_ekf import K, rand_problem


def test_torch_two_process_initialize_and_fused_step(tmp_path):
    rng = np.random.default_rng(7)
    x, Pm = rand_problem(rng)
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01))
    params = make_params(cam, None, dt=1.0,
                         process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01)
    obs_mask = jnp.asarray(rng.uniform(size=K) < 0.8)
    obs = (measure.project_all(params, x)
           + jnp.asarray(rng.normal(scale=1.0, size=(K, 2))))
    path = tmp_path / "inputs.npz"
    np.savez(path, x=np.asarray(x), P=np.asarray(Pm), obs=np.asarray(obs),
             mask=np.asarray(obs_mask))

    port = free_port()
    worker = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line in worker output: {out[-500:]}"
        results.append(json.loads(lines[0][len("RESULT "):]))

    for i, r in enumerate(results):
        assert r["info"]["process_index"] == i
        assert r["info"]["process_count"] == 2
        assert r["info"]["backend"] == "gloo"
        assert r["multihost"] and r["symmetric"] and r["chol_info"] == 0
    assert results[0]["sum_x"] == results[1]["sum_x"]
    assert results[0]["sum_PP"] == results[1]["sum_PP"]

    x1, P1, _, _ = fused_update_health_predict(params, x, Pm, obs, obs_mask)
    np.testing.assert_allclose(results[0]["sum_x"], float(jnp.sum(x1)),
                               rtol=1e-9)
    np.testing.assert_allclose(results[0]["sum_PP"],
                               float(jnp.sum(P1 * P1)), rtol=1e-9)
