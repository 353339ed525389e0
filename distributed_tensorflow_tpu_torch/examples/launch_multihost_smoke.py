"""Supervised multi-process bring-up: the fleet launcher drives a real
process group end to end (the port of ``scripts/launch_multihost_smoke.py``).

    python -m distributed_tensorflow_tpu_torch.examples.launch_multihost_smoke
        [--device=cuda]

Parent mode (the default): ``fleet.launcher.local_topology(2, ...)``
assembles the env-var topology ``parallel/cluster.py`` reads, the
``Launcher`` spawns one child a host with heartbeat liveness, waits up to
300 s for them, and prints its report as one JSON line; the exit code is
0 only when every host completed.  A coordinator port taken by someone
else can hang the bring-up, so the parent tries up to three fresh ports.

Child mode (``--child``): the supervised host.  ``launcher.heartbeat()``,
then ``_launch.start`` starts the group on this rank's device (a legacy
``JOB_NAME=ps`` refuses there with ``LEGACY_PS_EXIT_CODE``), one
all-reduce of ``PROCESS_ID + 1`` as a tensor on the device, checked to
equal ``n (n + 1) / 2``, a heartbeat, and one line
``SMOKE proc=<id> chief=<bool> sum=<value> backend=<name> device=<dev>``.

``--device`` is ``cuda`` by default and raises without a card;
``--device=cpu`` runs the group on the CPU over gloo.  On the card NCCL
is used where each rank has a card of its own; ranks that share one card
run over gloo (``DTTPU_DIST_BACKEND=gloo``, which ``_launch.start``
honours: NCCL refuses two ranks on one device).
"""
import argparse
import json
import os
import socket
import sys
import tempfile

_MODULE = "distributed_tensorflow_tpu_torch.examples.launch_multihost_smoke"
_HOSTS, _TIMEOUT_S = 2, 300.0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true",
                    help="run as one supervised host (the launcher's child)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    return ap.parse_args(argv)


def child(args) -> int:
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.fleet import launcher
    from distributed_tensorflow_tpu_torch.parallel import cluster

    launcher.heartbeat()
    cfg = cluster.cluster_from_env()
    device = start(args.device, cfg)
    n = cluster.process_count()
    if n != cfg.num_processes:
        raise AssertionError(f"group of {n}, topology of {cfg.num_processes}")
    launcher.heartbeat()
    x = torch.tensor([float(cfg.process_id + 1)], device=device)
    dist.all_reduce(x)
    total = float(x.item())
    if total != n * (n + 1) / 2:
        raise AssertionError(f"all-reduce sum {total}, expected "
                             f"{n * (n + 1) / 2}")
    launcher.heartbeat()
    print(f"SMOKE proc={cfg.process_id} chief={cluster.is_chief()} "
          f"sum={total} backend={dist.get_backend()} device={device}",
          flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parent(args) -> int:
    import torch

    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.fleet import launcher as launcher_lib
    from distributed_tensorflow_tpu_torch.obs import metrics as metrics_lib

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda needs a CUDA card; pass "
                           "--device=cpu to run on the CPU")
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)}
    if cuda and torch.cuda.device_count() < _HOSTS:
        env["DTTPU_DIST_BACKEND"] = "gloo"       # ranks share a card
    report = {}
    for attempt in range(3):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as hb_dir:
            specs = launcher_lib.local_topology(
                _HOSTS, [sys.executable, "-m", _MODULE, "--child",
                         f"--device={args.device}"], port,
                extra_env=env, heartbeat_dir=hb_dir)
            lc = fleet.Launcher(specs, registry=metrics_lib.Registry(),
                                max_restarts=1,
                                heartbeat_timeout_s=120.0,
                                heartbeat_grace_s=120.0,
                                poll_interval_s=0.1)
            lc.start()
            chief = lc.chief_id
            done = lc.wait(timeout_s=_TIMEOUT_S)
            if not done:
                lc.stop()           # a hung bring-up: retry on a new port
            report = {"attempt": attempt, "port": port,
                      "completed": done, "succeeded": lc.succeeded,
                      "chief_at_start": chief,
                      "backend": env.get("DTTPU_DIST_BACKEND"),
                      "report": {str(k): v
                                 for k, v in lc.report().items()}}
            if done and lc.succeeded:
                break
    print(json.dumps(report), flush=True)
    return 0 if report.get("succeeded") else 1


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    return child(args) if args.child else parent(args)


if __name__ == "__main__":
    sys.exit(main())
