"""The port's command-line tools:
`python -m hypermerge_tpu_torch.tools.<name>`."""
