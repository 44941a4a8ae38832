"""Backend layer: CRDT compute + orchestration (SURVEY.md §1.3)."""
