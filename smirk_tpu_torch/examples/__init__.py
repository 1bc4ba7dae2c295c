"""The examples of the Predictor API (twins of the repository's examples/):
`python -m smirk_tpu_torch.examples.predict | expression_edit |
reconstruct ...`, each with --device (default: the card)."""
