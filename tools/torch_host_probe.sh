#!/usr/bin/env bash
# Host facts that bound a swapped pass on the card's machine: the card and
# its power limit, host memory, the filesystem under the checkout and
# TMPDIR, the disk's write rate (3.2 GB through dd with fdatasync), and
# the rates of one pageable 10.8 GB copy down from and up to the card
# (torch only, no JAX). Run from the root of a checkout on the machine
# that holds the card (one H100, about four minutes):
#
#     bash tools/torch_host_probe.sh
set -x
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
head -3 /proc/meminfo
echo TMPDIR=$TMPDIR HOME=$HOME
df -hT . ${TMPDIR:-/tmp} /dev/shm
nproc
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda); from torch.nn.attention import flex_attention as f; print("flex ok")'
mkdir -p build
time dd if=/dev/zero of=build/ddtest bs=64M count=48 conv=fdatasync 2>&1 | tail -1
time python - <<'PY'
import torch, time
t=time.time(); x=torch.empty(int(2.7e9), device="cuda"); g=torch.Generator(device="cuda"); g.manual_seed(1); x.normal_(generator=g); torch.cuda.synchronize(); print("randn 2.7e9 on card", time.time()-t)
t=time.time(); y=x.cpu(); print("D2H 10.8 GB pageable", time.time()-t)
t=time.time(); z=y.to("cuda"); torch.cuda.synchronize(); print("H2D 10.8GB pageable", time.time()-t)
PY
rm -f build/ddtest
