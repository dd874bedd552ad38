#!/usr/bin/env bash
# Run the port's train or test CLI over Slurm nodes: one torchrun a node,
# one process a card.
#
#   bash dat_segmentation_tpu_torch/tools/launch_slurm.sh PARTITION JOB_NAME CONFIG DATA_ROOT [extra...]
#   MODE=test bash dat_segmentation_tpu_torch/tools/launch_slurm.sh PARTITION JOB_NAME CONFIG CKPT \
#       --data-root DATA_ROOT [extra...]
#
# For example, the UperNet recipe on two nodes of eight cards:
#
#   NNODES=2 bash dat_segmentation_tpu_torch/tools/launch_slurm.sh gpu dat_upn \
#       upn_tiny_160k_dp03_lr6 /data/ade20k --work-dir work_dirs/upn_tiny
#
# and on one node of eight cards with each 896x896 crop's rows split over
# two cards (the mesh's spatial axis, four data coordinates):
#
#   bash dat_segmentation_tpu_torch/tools/launch_slurm.sh gpu dat_upn_896 \
#       upn_tiny_160k_dp03_lr6 /data/ade20k --work-dir work_dirs/upn_tiny_896 \
#       --set "mesh_shape={'data': 4, 'spatial': 2}" "data.crop_size=(896, 896)"
#
# Environment (the defaults in brackets):
#   NNODES          nodes [1]
#   GPUS_PER_NODE   processes a node, one a card [the cards nvidia-smi -L lists there]
#   CPUS            cpus a task, that is a node's torchrun [16]
#   SRUN_ARGS       more srun arguments [none]
#   MODE            train, or test for the test CLI with --distributed [train]
#   MASTER_PORT     the rendezvous port on the first node [29500]
#
# On each node the task runs torchrun with --node_rank $SLURM_NODEID and
# --master_addr the first host of $SLURM_JOB_NODELIST.
# parallel/mesh.py:init_distributed reads what torchrun sets.

set -euo pipefail

PARTITION=${1:?usage: launch_slurm.sh PARTITION JOB_NAME CONFIG ARG [extra...]}
JOB_NAME=${2:?usage: launch_slurm.sh PARTITION JOB_NAME CONFIG ARG [extra...]}
CONFIG=${3:?usage: launch_slurm.sh PARTITION JOB_NAME CONFIG ARG [extra...]}
ARG=${4:?usage: launch_slurm.sh PARTITION JOB_NAME CONFIG ARG [extra...]}
shift 4

NNODES=${NNODES:-1}
CPUS=${CPUS:-16}
SRUN_ARGS=${SRUN_ARGS:-}
MODE=${MODE:-train}
export NNODES MASTER_PORT=${MASTER_PORT:-29500}  # srun hands the environment to the tasks

if [ "$MODE" = "test" ]; then
    # ARG is the checkpoint; --data-root comes with the extra arguments
    CLI=(-m dat_segmentation_tpu_torch.tools.test "$CONFIG" "$ARG" --distributed "$@")
else
    CLI=(-m dat_segmentation_tpu_torch.tools.train "$CONFIG" --data-root "$ARG" --multihost "$@")
fi

ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

# runs on each node, with Slurm's variables of that node
TASK='exec python3 -m torch.distributed.run --nnodes "$NNODES" \
    --nproc_per_node "${GPUS_PER_NODE:-$(nvidia-smi -L | wc -l)}" --node_rank "$SLURM_NODEID" \
    --master_addr "$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)" \
    --master_port "$MASTER_PORT" "$@"'

# shellcheck disable=SC2086  # SRUN_ARGS is a list of arguments
exec srun -p "$PARTITION" \
    --job-name="$JOB_NAME" \
    --nodes="$NNODES" \
    --ntasks="$NNODES" \
    --ntasks-per-node=1 \
    --cpus-per-task="$CPUS" \
    --kill-on-bad-exit=1 \
    $SRUN_ARGS \
    bash -c "$TASK" launch_slurm "${CLI[@]}"
