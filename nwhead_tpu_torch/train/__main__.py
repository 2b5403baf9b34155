"""``python -m nwhead_tpu_torch.train``: see the package's docstring."""

from nwhead_tpu_torch.train import main

if __name__ == "__main__":
    main()
