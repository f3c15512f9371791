"""Minion: background task execution framework + built-in tasks.

Reference parity: pinot-minion/ (TaskExecutorFactoryRegistry, task
executors, event observers), controller-side PinotTaskManager + generators
(pinot-controller/.../helix/core/minion/), and the built-in tasks in
pinot-plugins/pinot-minion-tasks/pinot-minion-builtin-tasks: MergeRollup,
Purge, RealtimeToOfflineSegments, SegmentGenerationAndPush,
UpsertCompaction. The segment processing framework
(pinot-core/.../segment/processing/framework/) is minion's map/partition/
reduce engine over segments.

Port of ``pinot_tpu/minion/``: the same framework, generators and
built-in tasks. Their output segments are byte-equal to the JAX
package's on the same inputs, and a task's outputs load on its data
manager's device (the card unless the table was made on the CPU).
"""
from .framework import (MinionContext, MinionWorker, TaskManager, TaskSpec,
                        TaskState, register_task_executor, task_executor_types)
from .processing import ProcessorConfig, RollupConfig, process_segments
from . import tasks as _builtin_tasks  # noqa: F401 — registers executors

__all__ = [
    "MinionContext", "MinionWorker", "TaskManager", "TaskSpec", "TaskState",
    "register_task_executor", "task_executor_types",
    "ProcessorConfig", "RollupConfig", "process_segments",
]
