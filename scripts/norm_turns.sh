#!/bin/sh
# K3 / K5 of a parent tree and of this tree in turns on one card (parent,
# this tree, this tree, parent): chip_smoke.py's K3 / K5 cases at the step's
# shapes (``--norm``, kernel / library times also as CUDA graphs), then the
# Swin-S pretrain step's device time by kernel family (profile_step), in
# the same order. Unpack the parent first into a directory that .gitignore
# lists; this tree's chip_smoke.py is copied into it, so both trees run the
# same cases, each on its own kernels (each builds into its own build/).
#
#     mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
#     sh scripts/norm_turns.sh build/parent [out-dir]
#
# Full outputs go to out-dir (default build/norm_turns); the check lines
# and the family tables are also printed.
set -e
parent=$1
out=${2:-build/norm_turns}
here=$(pwd)
mkdir -p "$out"
cp chip_smoke.py "$parent/chip_smoke.py"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for turn in parent change change parent; do
    i=$((i + 1))
    dir=$here
    [ "$turn" = parent ] && dir=$parent
    log="$here/$out/norm_${i}_$turn.txt"
    (cd "$dir" && python3 chip_smoke.py --norm) > "$log" 2>&1
    echo "== norm turn $i ($turn)"
    grep -E '^check|^build' "$log" | sed 's/ plain [0-9.]* ms//'
done
i=0
for turn in parent change change parent; do
    i=$((i + 1))
    dir=$here
    [ "$turn" = parent ] && dir=$parent
    log="$here/$out/profile_${i}_$turn.txt"
    (cd "$dir" && python3 -m mvlt_tpu_torch.profile_step --path swin_pretrain) > "$log" 2>&1
    echo "== profile turn $i ($turn)"
    sed -n '/train step b/,/^K1 gemm by part/p' "$log"
done
