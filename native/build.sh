#!/bin/sh
# Build libgamma_host.so (and the C++ client demo) next to this script.
# Each output is compiled under a name private to this build and renamed
# into place, so concurrent builds never expose a half-written library
# to a process that loads it.
set -e
cd "$(dirname "$0")"
tmp="libgamma_host.so.tmp.$$"
trap 'rm -f "$tmp" "gamma_client_demo.tmp.$$"' EXIT
g++ -O3 -std=c++17 -fPIC -shared -pthread -fvisibility=hidden \
    -o "$tmp" gamma_host.cc -l:libzstd.so.1
mv -f "$tmp" libgamma_host.so
echo "built $(pwd)/libgamma_host.so"
g++ -O2 -std=c++17 -o "gamma_client_demo.tmp.$$" gamma_client.cc
mv -f "gamma_client_demo.tmp.$$" gamma_client_demo
echo "built $(pwd)/gamma_client_demo"
