"""Command-line entry — the reference's ``Common::Main``
(``mainwrapper.cpp:5-54``): parse config -> echo -> seed -> build clouds ->
run the registered algorithm -> print R/t/error -> optional visualization.

A copy of ``tpuslam/harness/cli.py`` for the port, with the same stdout
contract.  Usage (the reference's CLI contract, ``configparser.cpp:11-39``):

    python -m tpuslam_torch [--device cpu|cuda[:N]] [config.json]

plus a ``--test-set`` mode replacing the reference's compile-time ``TEST``
macro (``gpumain.cpp:40-57``):

    python -m tpuslam_torch [--device ...] --test-set sizes
                            [--methods icp,nicp,cpd] [--out DIR]
                            [--warmup] [--resume]

``--device`` (first, before any other argument) stands where the JAX
CLI's ``--platform`` stands.  The default is ``cuda``: without a card the
CLI says so on stderr, naming the flag, and exits 1; it runs on the CPU
only when asked to by ``--device cpu``.  The device a run uses is named
on stderr, so that stdout keeps the JAX CLI's contract.

``--serve`` runs a warm JSONL registration service on stdin/stdout
(see ``run_serve``): one process, many registrations, the kernels built
and the card's context kept across requests.

``--warmup`` runs each test once untimed before the timed run, so the
kernels' build never lands in the CSV ``time(ms)`` column.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from tpuslam_torch.algorithms.registry import run_with_configuration
from tpuslam_torch.config.configuration import ComputationMethod
from tpuslam_torch.config.parser import ConfigParser
from tpuslam_torch.data.synthesis import get_clouds_from_config, transform_cloud


def cli_device(device: str) -> Optional[torch.device]:
    """The device a CLI run uses, named on stderr; None, after one line on
    stderr naming ``--device``, when it is not one this machine has (CUDA
    without a card included: the CLI never falls back to the CPU)."""
    try:
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise RuntimeError(f"unsupported device type '{dev.type}'")
    except RuntimeError as exc:
        print(f"[tpuslam_torch] --device {device}: {exc}; use --device "
              f"cpu or --device cuda[:N]", file=sys.stderr)
        return None
    if dev.type == "cpu":
        print("[tpuslam_torch] device: cpu", file=sys.stderr)
        return dev
    if not torch.cuda.is_available():
        print(f"[tpuslam_torch] --device {device}: no CUDA device is "
              f"available; pass --device cpu (first, before any other "
              f"argument) to run on the CPU", file=sys.stderr)
        return None
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        print(f"[tpuslam_torch] --device {device}: this machine has "
              f"{torch.cuda.device_count()} CUDA device(s)", file=sys.stderr)
        return None
    dev = torch.device("cuda", index)
    print(f"[tpuslam_torch] device: {dev} ({torch.cuda.get_device_name(dev)})",
          file=sys.stderr)
    return dev


def _print_matrix(rotation: np.ndarray, translation: np.ndarray) -> None:
    """Result echo in the spirit of ``PrintMatrix``
    (``common.cpp:367-397``)."""
    for r in range(3):
        row = " ".join(f"{rotation[r, c]: .6f}" for c in range(3))
        print(f"{row}  | {translation[r]: .6f}")


def run_config(argv: List[str], device: str = "cuda") -> int:
    dev = cli_device(device)
    if dev is None:
        return 1
    parser = ConfigParser(argv)
    if not parser.is_correct():
        print("Aborting!")
        return 1
    config = parser.get_configuration()
    config.print()

    before, after, _ = get_clouds_from_config(config)
    if len(before) == 0 or len(after) == 0:
        print("Empty cloud(s) — nothing to register")
        return 1

    rotation, translation, iterations, error = run_with_configuration(
        before, after, config, device=dev
    )
    print(f"Results for the {config.computation_method.value} method:")
    print("Transformation matrix:")
    _print_matrix(rotation, translation)
    print(f"Error: {error:f}")
    print(f"Iterations: {iterations}")

    if config.save_output_path:
        from tpuslam_torch.data.writer import save_cloud

        out_pts = transform_cloud(before, rotation, translation)
        if save_cloud(config.save_output_path, out_pts):
            print(f"Transformed cloud saved to {config.save_output_path}")
        else:
            print(
                f"Could not save transformed cloud to "
                f"{config.save_output_path} (.obj/.off, writable path)"
            )

    if config.show_visualisation:
        from tpuslam_torch.viz.view import show_registration
        from tpuslam_torch.viz.webgl import export_html

        transformed = transform_cloud(before, rotation, translation)
        # interactive artifact (the reference opens a GLFW window,
        # mainwrapper.cpp:39-51; on a headless host the equivalent is a
        # self-contained WebGL HTML) + static PNG where matplotlib is
        export_html(before, after, transformed)
        show_registration(before, after, transformed)
    return 0


def run_test_set_cli(args: List[str], device: str = "cuda") -> int:
    from tpuslam_torch.harness.runner import run_test_set
    from tpuslam_torch.harness.testsets import TEST_SETS

    name = args[0] if args else "sizes"
    if name not in TEST_SETS:
        print(f"Unknown test set '{name}'; one of {sorted(TEST_SETS)}")
        return 1
    methods = list(ComputationMethod)
    out_dir = "."
    warmup = False
    resume = False
    rest = args[1:]
    while rest:
        flag = rest.pop(0)
        if flag == "--methods" and rest:
            try:
                methods = [
                    ComputationMethod(m.strip())
                    for m in rest.pop(0).split(",")
                ]
            except ValueError as exc:
                print(
                    f"Unknown method ({exc}); one of "
                    f"{[m.value for m in ComputationMethod]}"
                )
                return 1
        elif flag == "--out" and rest:
            out_dir = rest.pop(0)
        elif flag == "--warmup":
            # run each test once untimed first (one-off costs excluded
            # from the recorded time)
            warmup = True
        elif flag == "--resume":
            # continue an interrupted run: keep completed CSV rows and
            # skip their configurations
            resume = True
        else:
            print(f"Unknown flag {flag}")
            return 1
    dev = cli_device(device)
    if dev is None:
        return 1
    if name == "noise":
        # the noise suite carries a ground-truth grading sidecar
        # (noise-tiers-<method>.jsonl) on top of the reference CSV
        from tpuslam_torch.harness.noise import run_noise_test_set

        files = run_noise_test_set(
            methods, output_dir=out_dir, warmup=warmup, resume=resume,
            device=dev,
        )
    else:
        files = run_test_set(
            TEST_SETS[name], name, methods, output_dir=out_dir,
            warmup=warmup, resume=resume, device=dev,
        )
    print("Wrote: " + ", ".join(files))
    return 0


def run_serve(inp=None, out=None, device: str = "cuda") -> int:
    """``--serve``: a warm registration service on stdin/stdout.

    ONE process keeps the kernels built and the card's context and
    allocator warm across many registrations.  Protocol: one JSON request
    per line, the same key contract as a config file
    (``config/schema.json``); one JSON response per line:

        {"ok": true, "rotation": [[...]x3], "translation": [...],
         "iterations": N, "error": E}
      | {"ok": false, "error": "..."}

    Responses are the ONLY stdout output; all diagnostics (config echo,
    parse errors) go to stderr.  EOF ends the loop.  The service keeps
    one CUDA graph of the ICP loop per shape it meets, for its life
    (``icp.graph_scope``)."""
    from tpuslam_torch.algorithms.icp import graph_scope

    dev = cli_device(device)
    if dev is None:
        return 1
    inp = sys.stdin if inp is None else inp
    out = sys.stdout if out is None else out
    with graph_scope():
        return _serve_lines(inp, out, dev)


def _serve_lines(inp, out, dev) -> int:
    """``run_serve``'s loop: a response for each request line."""
    import contextlib
    import json as _json

    served = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            request = _json.loads(line)
            if not isinstance(request, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            out.write(_json.dumps({"ok": False, "error": str(exc)}) + "\n")
            out.flush()
            served += 1
            continue
        # a single bad request must never end the service: anything the
        # pipeline raises (synthesis on degenerate values, registration
        # on adversarial parameters) becomes an error response
        try:
            with contextlib.redirect_stdout(sys.stderr):
                parser = ConfigParser.from_dict(request)
                if not parser.is_correct():
                    response = {"ok": False, "error": "invalid config"}
                else:
                    config = parser.get_configuration()
                    before, after, _ = get_clouds_from_config(config)
                    if len(before) == 0 or len(after) == 0:
                        response = {"ok": False, "error": "empty cloud(s)"}
                    else:
                        rotation, translation, iterations, error = (
                            run_with_configuration(
                                before, after, config, device=dev
                            )
                        )
                        if config.save_output_path:
                            from tpuslam_torch.data.writer import save_cloud

                            save_cloud(
                                config.save_output_path,
                                transform_cloud(
                                    before, rotation, translation
                                ),
                            )
                        response = {
                            "ok": True,
                            "rotation": np.asarray(rotation).tolist(),
                            "translation": np.asarray(translation).tolist(),
                            "iterations": int(iterations),
                            "error": float(error),
                        }
        except Exception as exc:  # noqa: BLE001 — keep serving
            response = {"ok": False, "error": repr(exc)}
        out.write(_json.dumps(response) + "\n")
        out.flush()
        served += 1
    print(f"Served {served} request(s)", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if len(argv) >= 2 and argv[0] == "--device":
        device, argv = argv[1], argv[2:]
    if argv and argv[0] == "--serve":
        return run_serve(device=device)
    if argv and argv[0] == "--test-set":
        return run_test_set_cli(argv[1:], device=device)
    return run_config(argv, device=device)


if __name__ == "__main__":
    sys.exit(main())
