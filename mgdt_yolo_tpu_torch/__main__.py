"""The command line: ``python -m mgdt_yolo_tpu_torch TASK MODE key=value ...``
(`cfg.entrypoint`)."""
from .cfg import entrypoint
from .utils.settings import set_logging

if __name__ == "__main__":
    set_logging()
    entrypoint()
