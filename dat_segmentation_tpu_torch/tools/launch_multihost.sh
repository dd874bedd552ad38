#!/usr/bin/env bash
# Run the port's train CLI on this node under torchrun, one process a card.
#
#   bash dat_segmentation_tpu_torch/tools/launch_multihost.sh CONFIG DATA_ROOT [extra...]
#
# On each of NNODES nodes, with NODE_RANK 0 ... NNODES-1 and MASTER_ADDR the
# address of node 0 (the same on every node):
#
#   NNODES=2 NODE_RANK=0 MASTER_ADDR=node0 \
#       bash dat_segmentation_tpu_torch/tools/launch_multihost.sh \
#       upn_tiny_160k_dp03_lr6 /data/ade20k --set data.batch_size=16
#
# Environment (the defaults in brackets):
#   NNODES          nodes [1]
#   GPUS_PER_NODE   processes on this node, one a card [the cards nvidia-smi -L lists]
#   NODE_RANK       this node's rank [0]
#   MASTER_ADDR     node 0's address [localhost]
#   MASTER_PORT     its rendezvous port [29500]
#
# Each process joins the group with --multihost
# (parallel/mesh.py:init_distributed reads what torchrun sets); the config's
# data.batch_size is the global batch. Extra arguments go to the train CLI.

set -euo pipefail

CONFIG=${1:?usage: launch_multihost.sh CONFIG DATA_ROOT [extra args...]}
DATA_ROOT=${2:?usage: launch_multihost.sh CONFIG DATA_ROOT [extra args...]}
shift 2

NNODES=${NNODES:-1}
GPUS_PER_NODE=${GPUS_PER_NODE:-$(nvidia-smi -L | wc -l)}
NODE_RANK=${NODE_RANK:-0}
MASTER_ADDR=${MASTER_ADDR:-localhost}
MASTER_PORT=${MASTER_PORT:-29500}

# the package's parent directory, so that -m finds it from any directory
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

exec python3 -m torch.distributed.run \
    --nnodes "$NNODES" --nproc_per_node "$GPUS_PER_NODE" --node_rank "$NODE_RANK" \
    --master_addr "$MASTER_ADDR" --master_port "$MASTER_PORT" \
    -m dat_segmentation_tpu_torch.tools.train "$CONFIG" --data-root "$DATA_ROOT" --multihost "$@"
