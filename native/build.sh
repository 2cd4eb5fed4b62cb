#!/bin/sh
# Build the native host codec shared library.
#
# Usage: build.sh [OUTPUT_PATH]   (default: libwtc_codec.so next to the
# source).  The auto-rebuild in wavelet_tpu/native/__init__.py calls this
# with a temp path and atomic-renames — this script is the single home of
# the compile flags.
#
# Needs a C++17 compiler and the liblzma 5 runtime (liblzma.so.5); the
# liblzma API headers are vendored in third_party/ (liblzma 5.4.1, public
# domain), so machines without the xz development package build too.
set -e
cd "$(dirname "$0")"
OUT=${1:-libwtc_codec.so}
g++ -O3 -march=native -std=c++17 -shared -fPIC -Ithird_party -o "$OUT" \
    wtc_codec.cpp -l:liblzma.so.5 -lpthread
echo "built $OUT"
