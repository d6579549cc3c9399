"""Tools of the port: ``python -m ccx_torch.tools.gen_docs OUT_DIR``."""
