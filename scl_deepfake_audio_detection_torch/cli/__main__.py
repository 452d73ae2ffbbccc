import sys

from scl_deepfake_audio_detection_torch.cli import main

sys.exit(main())
