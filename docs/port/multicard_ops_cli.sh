#!/usr/bin/env bash
# The operations path through its entry points on the cards of one host
# (four give the split cuda:0 -> cuda:2): bench.py's elastic storm row in
# one process, the 7B served disaggregated by the default tier split,
# and the comm bench's reshard rows over NCCL on four ranks (rows under
# build/ops_cli/). From the repository root:
#
#     bash docs/port/multicard_ops_cli.sh
set -u
echo "== train elastic (one process, default device)"
python -m tpu_hpc_torch.train --workload elastic --elastic-shrink-at 2 --elastic-grow-at 4 2>&1 | tail -3
echo "RC_TRAIN_ELASTIC $?"
echo "== serve disagg (default split over the visible cards)"
python -m tpu_hpc_torch.serve --paged --kv-kernel cuda --model 7b --prefill-chunk 256 --buckets 256,512 --max-seq-len 1024 --disagg --disagg-max-inflight-mb auto --requests 16 --max-new 32 --prompt-lens 100,180,260,340,420,500 2>&1 | tail -1 | python3 -c "import sys,json; r=json.loads(sys.stdin.read()); d=r['disagg']; print(json.dumps({'device': r['device'], 'requests': r['requests'], 'tokens': r['tokens'], 'recompiles': r['recompiles'], 'ttft_ms_p50': r['ttft_ms_p50'], 'ttft_ms_p95': r['ttft_ms_p95'], 'itl_ms_p50': r['itl_ms_p50'], 'itl_ms_p95': r['itl_ms_p95'], 'kernel_launches': r['kernel_launches'], 'peak_memory_bytes': r['peak_memory_bytes'], 'disagg': {k: v for k, v in d.items() if k != 'kv_plans'}}))"
echo "RC_SERVE_DISAGG $?"
echo "== comm bench reshard rows on 4 ranks"
mkdir -p build/ops_cli
torchrun --nproc-per-node 4 -m tpu_hpc_torch.comm.bench --op reshard_exchange --op reshard_replicate --output build/ops_cli/reshard_bench_4cards.csv 2>&1 | tail -2
echo "RC_BENCH $?"
python3 -c "
import json
for l in open('build/ops_cli/reshard_bench_4cards.jsonl'):
    r=json.loads(l)
    if r['unit']=='ms': print(r['metric'], round(r['value'],4), 'chunks', r['chunks'], 'wire', r['wire_bytes_modeled'], 'GB/s', round(r['busbw_GB_s'],2), 'plan_ms', r['plan_ms'])
"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
