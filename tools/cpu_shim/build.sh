#!/bin/bash
# Build the CUDA sources of a csrc/ directory with g++ under the thread shim
# (cuda_runtime.h here) into a shared library with the kernels' C entry
# points:  tools/cpu_shim/build.sh j40_tpu_torch/csrc build/libshim.so
# Set EXTRA=-fsanitize=address for the address sanitizer.
set -e
here=$(cd "$(dirname "$0")" && pwd)
src=$1; out=$2; tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
for f in "$src"/*.cu "$src"/*.cuh; do python3 "$here/prep.py" "$f" "$tmp/$(basename "$f")"; done
cp "$here/cuda_runtime.h" "$tmp/"
objs=""
for f in "$tmp"/*.cu; do
  g++ -std=c++20 -O1 -g -fPIC -x c++ -I"$tmp" -c "$f" -o "$f.o" ${EXTRA}
  objs="$objs $f.o"
done
g++ -std=c++20 -O1 -g -fPIC -I"$tmp" -c "$here/shim.cpp" -o "$tmp/shim.o" ${EXTRA}
g++ -shared -o "$out" $objs "$tmp/shim.o" -lpthread ${EXTRA}
