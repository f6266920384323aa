"""``python -m dqgp_tpu_torch <flags>``: the port's CLI (``cli.main``)."""

from .cli import main

if __name__ == "__main__":
    main()
