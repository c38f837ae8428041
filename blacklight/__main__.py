from blacklight.cli import main
import sys

sys.exit(main())
