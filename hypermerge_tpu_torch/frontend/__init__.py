"""Frontend layer: materialized docs, handles, synchronous API
(SURVEY.md §1.2)."""
