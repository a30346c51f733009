#!/usr/bin/env bash
# Environment setup helpers (the analog of the reference's env/bash per-machine
# module loads + build_jaybenne cmake wrapper; there is no build step here).
#
# Source this file:   source env/setup.sh [cpu|gpu]
#
#   cpu : force the XLA CPU backend with an 8-device virtual mesh (tests, CI)
#   gpu : JAX's default backend (the GPU where JAX's CUDA plugin finds one)
#
# Then run:
#   mcblock -i inputs/stepdiff.in           # if pip-installed (pip install -e .)
#   python -m jaybenne_tpu.driver -i ...    # from the repo root otherwise
#   python -m pytest tests/ -x -q
#   (cd tst && python stepdiff.py)

_repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${_repo_root}${PYTHONPATH:+:${PYTHONPATH}}"

case "${1:-gpu}" in
  cpu)
    export JAX_PLATFORMS=cpu
    export XLA_FLAGS="${XLA_FLAGS:-} --xla_force_host_platform_device_count=8"
    echo "jaybenne_tpu env: CPU backend, 8 virtual devices"
    ;;
  gpu)
    unset JAX_PLATFORMS 2>/dev/null || true
    echo "jaybenne_tpu env: default (GPU) backend"
    ;;
  *)
    echo "usage: source env/setup.sh [cpu|gpu]" >&2
    ;;
esac
