"""Backup and DR: continuous backup to containers, cluster-to-cluster
replication — the analog of fdbclient/FileBackupAgent.actor.cpp,
DatabaseBackupAgent.actor.cpp, BackupContainer.actor.cpp."""

from .container import BackupContainer  # noqa: F401
from .agent import BackupAgent, DrAgent  # noqa: F401
