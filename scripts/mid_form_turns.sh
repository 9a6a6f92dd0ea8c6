#!/bin/sh
# K2 / K4 at the fusion's middle lengths (160 < N <= 288) of a parent tree
# and of this tree in turns on one card: the parent's own K2 / K4 checks at
# S = 221 / 278 (`long_attention_checks`), 201 and 180
# (`caption_kernel_checks`, `iu_xray_kernel_checks`), each timed eagerly and
# as CUDA graphs beside its library call and bound, then this tree's
# `chip_smoke.py --mid-n` (the same cases in every form that takes them,
# then the caption step and the ViT-B/16 pretrain step with their K2 / K4
# launch lengths); then, unless PROFILE=0, `profile_step --path
# caption_step` (S = 201) and `--path pretrain --conv vit` (S = 278: device
# time by kernel family and the top kernels) parent, this tree, this tree,
# parent. Unpack the parent first into a directory that .gitignore lists;
# each tree builds into its own build/.
#
#     mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#     sh scripts/mid_form_turns.sh build/parent [out-dir]
#
# Full outputs go to out-dir (default build/mid_form_turns); the check
# lines, the plans, ptxas's report and the profiles' family tables are also
# printed. A turn that fails is reported and the others still run; the exit
# code is the number of failed turns.
parent=$1
out=${2:-build/mid_form_turns}
here=$(pwd)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
failed=0
i=0
for turn in parent change; do
    i=$((i + 1))
    log="$here/$out/mid_n_${i}_$turn.txt"
    t0=$(date +%s)
    if [ "$turn" = parent ]; then
        (cd "$parent" && python3 -c '
import sys, chip_smoke as c
started = c.start()
if started is None:
    sys.exit(1)
chk = c.Checker()
for checks in (c.long_attention_checks, c.caption_kernel_checks,
               c.iu_xray_kernel_checks):
    checks(chk, started[0])
') > "$log" 2>&1
    else
        python3 chip_smoke.py --mid-n > "$log" 2>&1
    fi || { failed=$((failed + 1)); echo "mid-n turn $i ($turn) FAILED"; tail -5 "$log"; }
    echo "== mid-n turn $i ($turn), $(($(date +%s) - t0)) s"
    grep -E '^check biased_attention(_bwd)?_(long_n|n201|n180)|^mid-n|^plan at|^build|ptxas -v|^K[24] at S|ms/step' "$log"
done
[ "${PROFILE:-1}" = 0 ] && exit $failed
i=0
for turn in parent change change parent; do
    dir=$here
    [ "$turn" = parent ] && dir=$parent
    for path in "caption_step" "pretrain --conv vit"; do
        i=$((i + 1))
        log="$here/$out/profile_${i}_$turn.txt"
        # shellcheck disable=SC2086
        (cd "$dir" && python3 -m mvlt_tpu_torch.profile_step --path $path) > "$log" 2>&1 || {
            failed=$((failed + 1)); echo "profile turn $i ($turn) FAILED"; tail -5 "$log"; }
        echo "== profile turn $i ($turn): $path"
        sed -n '/unprofiled step times/,/^K1 gemm by part/p' "$log"
        grep -E 'attention_(wgmma|mid|long|bwd_dq|bwd_dkv)' "$log"
    done
done
exit $failed
