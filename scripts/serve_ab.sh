#!/bin/bash
# A/B of the serve launcher at full width on one GPU: another checkout of
# the repository (the parent commit, unpacked with `git archive` into a
# directory that .gitignore lists) against this tree, in turns parent,
# change, change, parent, dense and paged each time; prints the card and
# each run's engine line (prefills, decode ticks and their seconds).
#
#     bash scripts/serve_ab.sh build/parent
set -e
parent=${1:?usage: serve_ab.sh PARENT_DIR}
for d in "$parent" .; do
  (cd "$d" && PYTHONPATH=src python -c \
    "from repro_torch.kernels import build; build.build_all()" > /dev/null) &
done
wait
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for d in "$parent" . . "$parent"; do
  for p in "" "--paged"; do
    echo "=== side $d layout ${p:-dense}"
    (cd "$d" && PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3_1_7b --sell acdc --sell-method pallas --slots 4 \
      --prompt-len 64 --gen 16 --requests 8 $p 2>&1 \
      | grep -E "^\[engine\]|rid=")
  done
done
