"""``python -m piccolo_tpu_torch``: the same CLI as ``piccolo_tpu_torch.main``."""

from .main import main

if __name__ == "__main__":
    main()
