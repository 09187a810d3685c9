"""``python -m kafkastreams_cep_tpu_torch.profile`` entry point."""

import sys

from kafkastreams_cep_tpu_torch.profile import main

if __name__ == "__main__":
    sys.exit(main())
