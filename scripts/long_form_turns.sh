#!/bin/sh
# K2 / K4's long form of a parent tree and of this tree in turns on one card:
# each tree's own `chip_smoke.py --long-n` (the long-form kernel checks at
# S = 298, 348 and 474 in five modes, each timed eagerly and as CUDA graphs
# beside its library call and bound, then the long-form paths), parent then
# this tree; then `profile_step --path caption_step --conv vit` (the
# ViT-B/16 caption step's device time by kernel family) parent, this tree,
# this tree, parent. Unpack the parent first into a directory that
# .gitignore lists; each tree builds into its own build/.
#
#     mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#     sh scripts/long_form_turns.sh build/parent [out-dir]
#
# Full outputs go to out-dir (default build/long_form_turns); the long-form
# check lines, the plans and the family tables are also printed. A turn that
# fails is reported and the others still run; the exit code is the number of
# failed turns.
parent=$1
out=${2:-build/long_form_turns}
here=$(pwd)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
failed=0
i=0
for turn in parent change; do
    i=$((i + 1))
    dir=$here
    [ "$turn" = parent ] && dir=$parent
    log="$here/$out/long_n_${i}_$turn.txt"
    t0=$(date +%s)
    (cd "$dir" && python3 chip_smoke.py --long-n) > "$log" 2>&1 || {
        failed=$((failed + 1)); echo "long-n turn $i ($turn) FAILED"; tail -5 "$log"; }
    echo "== long-n turn $i ($turn), $(($(date +%s) - t0)) s"
    grep -E '^check biased_attention(_bwd)?_long_form|long form at S|^build|ptxas -v|host time' "$log" \
        | sed 's/ plain [0-9.]* ms//'
done
i=0
for turn in parent change change parent; do
    i=$((i + 1))
    dir=$here
    [ "$turn" = parent ] && dir=$parent
    log="$here/$out/profile_${i}_$turn.txt"
    (cd "$dir" && python3 -m mvlt_tpu_torch.profile_step --path caption_step --conv vit) > "$log" 2>&1 || {
        failed=$((failed + 1)); echo "profile turn $i ($turn) FAILED"; tail -5 "$log"; }
    echo "== profile turn $i ($turn)"
    sed -n '/unprofiled step times/,/^K1 gemm by part/p' "$log"
    grep -E 'long_kernel' "$log"
done
exit $failed
