from ccx_torch.client.cli import main

raise SystemExit(main())
