"""Task queues and the task lifecycle: leases, retries, dead-letter, ledger."""
