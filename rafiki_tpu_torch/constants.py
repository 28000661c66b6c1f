"""Enums shared across the framework.

The port's own copy of ``rafiki_tpu/constants.py``, unchanged: the
user, task, budget, status and service vocabularies, so rows written
by either package read the same in the other.
"""

from __future__ import annotations

import enum


class UserType(str, enum.Enum):
    SUPERADMIN = "SUPERADMIN"
    ADMIN = "ADMIN"
    MODEL_DEVELOPER = "MODEL_DEVELOPER"
    APP_DEVELOPER = "APP_DEVELOPER"


class TaskType(str, enum.Enum):
    IMAGE_CLASSIFICATION = "IMAGE_CLASSIFICATION"
    POS_TAGGING = "POS_TAGGING"
    GENERIC = "GENERIC"


class BudgetType(str, enum.Enum):
    # Reference: MODEL_TRIAL_COUNT / GPU_COUNT / TIME_HOURS.
    # TPU-native: CHIP_COUNT replaces GPU_COUNT (one trial per chip).
    MODEL_TRIAL_COUNT = "MODEL_TRIAL_COUNT"
    CHIP_COUNT = "CHIP_COUNT"
    GPU_COUNT = "GPU_COUNT"  # accepted alias for CHIP_COUNT (reference compat)
    TIME_HOURS = "TIME_HOURS"


class TrainJobStatus(str, enum.Enum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"
    COMPLETED = "COMPLETED"


class TrialStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ERRORED = "ERRORED"
    TERMINATED = "TERMINATED"


class InferenceJobStatus(str, enum.Enum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class ServiceType(str, enum.Enum):
    TRAIN_WORKER = "TRAIN_WORKER"
    INFERENCE_WORKER = "INFERENCE_WORKER"
    ADVISOR = "ADVISOR"
    PREDICTOR = "PREDICTOR"
    # The sweep supervisor's liveness lease (docs/recovery.md): a
    # RUNNING job whose SUPERVISOR heartbeats all went stale is a
    # crashed control plane — the resume reaper's detection signal.
    SUPERVISOR = "SUPERVISOR"


class ServiceStatus(str, enum.Enum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"
