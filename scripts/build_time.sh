#!/bin/sh
# Time the port's kernel build on a CUDA machine: the five sources of
# mvlt_tpu_torch/csrc compiled with the flags of mvlt_tpu_torch/ops/kernels.py
# (one nvcc each, all started together), with and without
# --split-compile=0, into a temporary directory; prints each source's
# seconds, the whole build's, and the first registers lines of K4's report.
# Run from the root of a checkout: sh scripts/build_time.sh
NVCC=${NVCC:-/usr/local/cuda/bin/nvcc}
OUT=$(mktemp -d)
"$NVCC" --version | tail -1
echo "cpus: $(nproc)"
for split in "--split-compile=0" ""; do
  start=$(date +%s)
  for src in gemm attention layernorm attention_bwd layernorm_bwd; do
    (s0=$(date +%s)
     "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 $split \
       -shared -Xcompiler -fPIC -Xptxas -v -o "$OUT/$src.so" \
       "mvlt_tpu_torch/csrc/$src.cu" > "$OUT/$src.log" 2>&1
     echo "  [$split] $src: $(( $(date +%s) - s0 )) s") &
  done
  wait
  echo "[$split] the five sources: $(( $(date +%s) - start )) s"
  grep "Used" "$OUT/attention_bwd.log" | head -3
done
rm -rf "$OUT"
